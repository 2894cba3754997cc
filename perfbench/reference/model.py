"""Plain PyTorch reference of the Oryon model (Corsetti et al., CVPR 2024).

CLIP ViT vision and text towers, Swin stages 1-2, the image-text fusion
(CATSeg-style aggregator) and the guided upsampling decoder, in float32 with
plain operations only: einsum attention, ``F.linear`` / ``F.conv2d``, the
separable resize as two matmuls.  Parameter names follow the served model's,
so one state dict loads into both.  It imports nothing of the program.

``Prec`` sets the precision of every product that the served model takes in
bf16 or int8: ``control=False`` computes them in float32 (the int8
projections as exact integer products of the int8 codes), ``control=True``
rounds their operands one step lower, bf16 -> float8 e4m3 (per-tensor
scale) and int8 -> int4 (the same absmax rule with 7 levels).  Products the
served model keeps in float32 (``clip_conv``, the mask head, norms,
softmax) stay float32 either way.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
FP8_MAX = 448.0


class Prec:
    """Precision of the reference's low-precision products (see module doc)."""

    def __init__(self, control: bool = False):
        self.control = control

    def low(self, t: torch.Tensor) -> torch.Tensor:
        """An operand the served model rounds to bf16."""
        if not self.control:
            return t
        s = torch.clamp(t.abs().amax(), min=1e-30) / FP8_MAX
        return (t / s).to(torch.float8_e4m3fn).float() * s

    @property
    def int_levels(self) -> float:
        return 7.0 if self.control else 127.0


def int_quantize(x: torch.Tensor, dim: int, levels: float):
    """Symmetric absmax codes along ``dim`` (kept) and their f32 scale."""
    amax = torch.amax(torch.abs(x), dim=dim, keepdim=True)
    scale = torch.clamp(amax, min=1e-12) / levels
    return torch.clamp(torch.round(x / scale), -levels, levels), scale


class Dense(nn.Module):
    """y = x W^T + b; ``low``: the served model computes it in bf16;
    ``quant``: in int8 (per-channel weight, per-token activation scales)."""

    def __init__(self, i: int, o: int, low: bool = True, bias: bool = True,
                 quant: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(o, i))
        self.bias = nn.Parameter(torch.zeros(o)) if bias else None
        self.low, self.quant = low, quant
        self.prec = Prec()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.quant:
            lv = self.prec.int_levels
            w8, ws = int_quantize(self.weight.float(), 1, lv)
            lead = x.shape[:-1]
            x8, xs = int_quantize(x.reshape(-1, x.shape[-1]), -1, lv)
            # integer sums exceed 2^24: exact in float64
            acc = (x8.double() @ w8.double().t()).float()
            out = acc * (xs * ws.reshape(1, -1))
            if self.bias is not None:
                out = out + self.bias
            return out.reshape(*lead, -1)
        w = self.weight
        if self.low:
            x, w = self.prec.low(x), self.prec.low(w)
        return F.linear(x, w, self.bias)


class Conv(nn.Module):
    """2-D convolution on NHWC tensors (weight [out, in, kh, kw])."""

    def __init__(self, i: int, o: int, k: int, stride: int = 1, padding: int = 0,
                 bias: bool = True, low: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(o, i, k, k))
        self.bias = nn.Parameter(torch.zeros(o)) if bias else None
        self.stride, self.padding, self.low = stride, padding, low
        self.prec = Prec()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w = x.float(), self.weight
        if self.low:
            x, w = self.prec.low(x), self.prec.low(w)
        y = F.conv2d(x.permute(0, 3, 1, 2), w, self.bias, self.stride, self.padding)
        return y.permute(0, 2, 3, 1)


class ConvTranspose(nn.Module):
    """Transposed convolution, stride == kernel, NHWC (weight [in, out, k, k])."""

    def __init__(self, i: int, o: int, k: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(i, o, k, k))
        self.bias = nn.Parameter(torch.zeros(o))
        self.k = k
        self.prec = Prec()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w = self.prec.low(x.float()), self.prec.low(self.weight)
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2), w, self.bias, stride=self.k)
        return y.permute(0, 2, 3, 1)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps

    def forward(self, x):
        return F.layer_norm(x.float(), (x.shape[-1],), self.weight, self.bias, self.eps)


class GroupNorm(nn.Module):
    """GroupNorm over NHWC tensors, consecutive channel groups."""

    def __init__(self, groups: int, channels: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.groups, self.eps = groups, eps

    def forward(self, x):
        B, H, W, C = x.shape
        g = x.float().reshape(B, H * W, self.groups, C // self.groups)
        mean = g.mean(dim=(1, 3), keepdim=True)
        var = (g - mean).square().mean(dim=(1, 3), keepdim=True)
        g = (g - mean) * torch.rsqrt(var + self.eps)
        return g.reshape(B, H, W, C) * self.weight + self.bias


# ---------------------------------------------------------------- resizing

def _cubic(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    at = np.abs(t)
    return np.where(at <= 1.0, (a + 2) * at ** 3 - (a + 3) * at ** 2 + 1,
                    np.where(at < 2.0, a * at ** 3 - 5 * a * at ** 2 + 8 * a * at - 4 * a,
                             0.0))


def resize_matrix(n_in: int, n_out: int, method: str, align_corners: bool) -> np.ndarray:
    """[n_out, n_in] interpolation weights: Keys cubic (a = -0.75) or linear
    with clamped taps, or torch-style nearest (floor(i * in / out))."""
    if n_in == n_out:
        return np.eye(n_out, dtype=np.float32)
    if align_corners and n_out > 1:
        src = np.arange(n_out, dtype=np.float64) * (n_in - 1) / (n_out - 1)
    else:
        src = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
    W = np.zeros((n_out, n_in), np.float64)
    rows = np.arange(n_out)
    if method == "nearest":
        idx = np.floor(np.arange(n_out) * n_in / n_out).astype(int)
        W[rows, np.clip(idx, 0, n_in - 1)] = 1.0
        return W.astype(np.float32)
    i0 = np.floor(src).astype(int)
    frac = src - i0
    taps = (((0, 1 - frac), (1, frac)) if method == "linear"
            else tuple((o, _cubic(o - frac)) for o in (-1, 0, 1, 2)))
    for off, w in taps:
        np.add.at(W, (rows, np.clip(i0 + off, 0, n_in - 1)), w)
    return W.astype(np.float32)


def resize2d(x: torch.Tensor, out_hw, method: str = "linear",
             align_corners: bool = False) -> torch.Tensor:
    """(..., H, W, C) -> (..., OH, OW, C) in float32."""
    H, W = x.shape[-3], x.shape[-2]
    Wh = torch.from_numpy(resize_matrix(H, out_hw[0], method, align_corners)).to(x.device)
    Ww = torch.from_numpy(resize_matrix(W, out_hw[1], method, align_corners)).to(x.device)
    y = torch.einsum("oh,...hwc->...owc", Wh, x.float())
    return torch.einsum("pw,...owc->...opc", Ww, y)


def unit(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=eps)


def _normalize(x, mean, std):
    return ((x - torch.tensor(mean, device=x.device))
            / torch.tensor(std, device=x.device))


# ---------------------------------------------------------------- CLIP

def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def softmax_attention(q, k, v, heads: int, bias=None):
    """q, k, v [B, L, C] -> [B, L, C]; bias broadcasts to [B, heads, L, L]."""
    B, L, C = q.shape
    hd = C // heads
    q, k, v = (t.reshape(B, -1, heads, hd).transpose(1, 2) for t in (q, k, v))
    a = torch.einsum("bhld,bhmd->bhlm", q, k) * hd ** -0.5
    if bias is not None:
        a = a + bias
    out = torch.einsum("bhlm,bhmd->bhld", torch.softmax(a, dim=-1), v)
    return out.transpose(1, 2).reshape(B, L, C)


class MultiHeadAttention(nn.Module):
    def __init__(self, width: int, heads: int, quant: bool = False):
        super().__init__()
        self.in_proj = Dense(width, 3 * width, quant=quant)
        self.out_proj = Dense(width, width, quant=quant)
        self.heads = heads

    def forward(self, x, mask=None):
        q, k, v = self.in_proj(x).chunk(3, dim=-1)
        return self.out_proj(softmax_attention(q, k, v, self.heads, mask))


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int, quant: bool = False):
        super().__init__()
        self.ln_1 = LayerNorm(width)
        self.attn = MultiHeadAttention(width, heads, quant)
        self.ln_2 = LayerNorm(width)
        self.mlp_c_fc = Dense(width, 4 * width, quant=quant)
        self.mlp_c_proj = Dense(4 * width, width, quant=quant)

    def forward(self, x, mask=None):
        x = x + self.attn(self.ln_1(x), mask)
        return x + self.mlp_c_proj(quick_gelu(self.mlp_c_fc(self.ln_2(x))))


class ClipVisionTower(nn.Module):
    """[B, S, S, 3] -> [B, S/p, S/p, width] patch tokens (CLS dropped)."""

    def __init__(self, c: dict, quant: bool):
        super().__init__()
        self.grid, self.width = c["image_size"] // c["patch_size"], c["width"]
        self.conv1 = Conv(3, c["width"], c["patch_size"], stride=c["patch_size"], bias=False)
        self.class_embedding = nn.Parameter(torch.empty(c["width"]))
        self.positional_embedding = nn.Parameter(torch.empty(self.grid ** 2 + 1, c["width"]))
        self.ln_pre = LayerNorm(c["width"])
        self.resblocks = nn.ModuleList(ResidualAttentionBlock(c["width"], c["heads"], quant)
                                       for _ in range(c["layers"]))
        self.ln_post = LayerNorm(c["width"])

    def forward(self, x):
        B, g, w = x.shape[0], self.grid, self.width
        x = self.conv1(x).reshape(B, g * g, w)
        x = torch.cat([self.class_embedding.expand(B, 1, w), x], 1) + self.positional_embedding
        x = self.ln_pre(x)
        for blk in self.resblocks:
            x = blk(x)
        return self.ln_post(x[:, 1:]).reshape(B, g, g, w)


class ClipTextTower(nn.Module):
    """Token ids [N, L] -> projected EOT embeddings [N, embed_dim]."""

    def __init__(self, c: dict):
        super().__init__()
        self.L = c["context_length"]
        self.token_embedding = nn.Parameter(torch.empty(c["vocab_size"], c["width"]))
        self.positional_embedding = nn.Parameter(torch.empty(self.L, c["width"]))
        self.resblocks = nn.ModuleList(ResidualAttentionBlock(c["width"], c["heads"])
                                       for _ in range(c["layers"]))
        self.ln_final = LayerNorm(c["width"])
        self.text_projection = nn.Parameter(torch.empty(c["width"], c["embed_dim"]))

    def forward(self, ids):
        ids = ids.long()
        x = self.token_embedding[ids] + self.positional_embedding
        causal = torch.triu(torch.full((self.L, self.L), float("-inf"), device=ids.device), 1)
        for blk in self.resblocks:
            x = blk(x, causal)
        x = self.ln_final(x)
        pooled = x[torch.arange(x.shape[0], device=x.device), ids.argmax(dim=-1)]
        return pooled @ self.text_projection


# ---------------------------------------------------------------- Swin

def relative_position_index(w: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w), indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0) + (w - 1)
    return (rel[..., 0] * (2 * w - 1) + rel[..., 1]).reshape(-1).astype(np.int64)


def shift_mask(H: int, W: int, w: int, shift: int, device) -> torch.Tensor:
    """[num_windows, w*w, w*w] additive mask of shifted-window attention."""
    img = np.zeros((H, W), np.float32)
    cnt = 0
    for hs in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
        for ws in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    wins = img.reshape(H // w, w, W // w, w).transpose(0, 2, 1, 3).reshape(-1, w * w)
    diff = wins[:, None, :] - wins[:, :, None]
    return torch.from_numpy(np.where(diff != 0, -100.0, 0.0).astype(np.float32)).to(device)


def window_partition(x, w):
    B, H, W, C = x.shape
    return (x.reshape(B, H // w, w, W // w, w, C).permute(0, 1, 3, 2, 4, 5)
            .reshape(-1, w * w, C))


def window_reverse(wins, w, B, H, W):
    return (wins.reshape(B, H // w, W // w, w, w, wins.shape[-1])
            .permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, -1))


def window_attention(q, k, v, heads, bias, mask):
    """Softmax attention in windows [Bw, N, C]; bias [heads, N, N]; mask
    [nw, N, N] with the windows of one image consecutive."""
    Bw, N, _ = q.shape
    b = 0.0 if bias is None else bias[None]
    if mask is not None:
        nw = mask.shape[0]
        b = (b + mask[:, None]).repeat(Bw // nw, 1, 1, 1)
    return softmax_attention(q, k, v, heads, b)


class WindowAttention(nn.Module):
    def __init__(self, dim, heads, window):
        super().__init__()
        self.qkv = Dense(dim, 3 * dim)
        self.proj = Dense(dim, dim)
        self.relative_position_bias_table = nn.Parameter(torch.empty((2 * window - 1) ** 2, heads))
        self.register_buffer("rel_index", torch.from_numpy(relative_position_index(window)),
                             persistent=False)
        self.heads, self.N = heads, window * window

    def forward(self, x, mask):
        q, k, v = self.qkv(x).chunk(3, dim=-1)
        bias = (self.relative_position_bias_table[self.rel_index]
                .reshape(self.N, self.N, self.heads).permute(2, 0, 1))
        return self.proj(window_attention(q, k, v, self.heads, bias, mask))


class SwinBlock(nn.Module):
    def __init__(self, dim, heads, window, shift, mlp_ratio):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, heads, window)
        self.norm2 = LayerNorm(dim)
        self.mlp_fc1 = Dense(dim, int(dim * mlp_ratio))
        self.mlp_fc2 = Dense(int(dim * mlp_ratio), dim)
        self.window, self.shift = window, shift

    def forward(self, x):
        B, H, W, C = x.shape
        w = self.window
        shift = self.shift if min(H, W) > w else 0
        y = self.norm1(x)
        Hp, Wp = -(-H // w) * w, -(-W // w) * w
        y = F.pad(y, (0, 0, 0, Wp - W, 0, Hp - H))
        mask = None
        if shift > 0:
            y = torch.roll(y, (-shift, -shift), (1, 2))
            mask = shift_mask(Hp, Wp, w, shift, x.device)
        y = window_reverse(self.attn(window_partition(y, w), mask), w, B, Hp, Wp)
        if shift > 0:
            y = torch.roll(y, (shift, shift), (1, 2))
        x = x + y[:, :H, :W]
        return x + self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm2(x))))


class PatchMerging(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.norm = LayerNorm(4 * dim)
        self.reduction = Dense(4 * dim, 2 * dim, bias=False)

    def forward(self, x):
        B, H, W, C = x.shape
        x = x.reshape(B, H // 2, 2, W // 2, 2, C)
        x = torch.cat([x[:, :, 0, :, 0], x[:, :, 1, :, 0], x[:, :, 0, :, 1],
                       x[:, :, 1, :, 1]], dim=-1)
        return self.reduction(self.norm(x))


class SwinGuidance(nn.Module):
    """[B, S, S, 3] -> [g1, g2, g3] taps of stages 1-2 (after each merge)."""

    def __init__(self, c: dict):
        super().__init__()
        e = c["embed_dim"]
        self.depths = c["depths"]
        self.patch_embed = Conv(3, e, 4, stride=4)
        self.patch_norm = LayerNorm(e)
        for s, (depth, dim, heads) in enumerate(zip(c["depths"], (e, 2 * e), c["heads"]), 1):
            for i in range(depth):
                self.add_module(f"stage{s}_block{i}", SwinBlock(
                    dim, heads, c["window"], 0 if i % 2 == 0 else c["window"] // 2,
                    c["mlp_ratio"]))
        self.merge1 = PatchMerging(e)
        self.merge2 = PatchMerging(2 * e)

    def _stage(self, x, s):
        for i in range(self.depths[s - 1]):
            x = getattr(self, f"stage{s}_block{i}")(x)
        return x

    def forward(self, x):
        x = self._stage(self.patch_norm(self.patch_embed(x)), 1)
        g3 = x
        x = self.merge1(x)
        g2 = x
        return [self.merge2(self._stage(x, 2)), g2, g3]


# ---------------------------------------------------------------- fusion

class GuidedWindowAttention(nn.Module):
    def __init__(self, dim, in_dim, heads):
        super().__init__()
        self.q, self.k = Dense(in_dim, dim), Dense(in_dim, dim)
        self.v, self.proj = Dense(dim, dim), Dense(dim, dim)
        self.dim, self.heads = dim, heads

    def forward(self, x, mask):
        return self.proj(window_attention(self.q(x), self.k(x), self.v(x[..., :self.dim]),
                                          self.heads, None, mask))


class GuidedSwinBlock(nn.Module):
    def __init__(self, dim, guid_dim, heads, window, shift):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = GuidedWindowAttention(dim, dim + guid_dim, heads)
        self.norm2 = LayerNorm(dim)
        self.mlp_fc1 = Dense(dim, 4 * dim)
        self.mlp_fc2 = Dense(4 * dim, dim)
        self.window, self.shift = window, shift

    def forward(self, x, guidance):
        B, H, W, C = x.shape
        w, shift = self.window, self.shift
        y = torch.cat([self.norm1(x), guidance], dim=-1)
        mask = None
        if shift > 0:
            y = torch.roll(y, (-shift, -shift), (1, 2))
            mask = shift_mask(H, W, w, shift, x.device)
        y = window_reverse(self.attn(window_partition(y, w), mask), w, B, H, W)
        if shift > 0:
            y = torch.roll(y, (shift, shift), (1, 2))
        x = x + y
        return x + self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm2(x))))


def linear_attention(q, k, v, eps: float = 1e-6):
    """ELU(+1) linear attention; q [N, L, H, D], k / v [N, S, H, D]."""
    Q, K = F.elu(q) + 1.0, F.elu(k) + 1.0
    s = v.shape[1]
    KV = torch.einsum("nshd,nshv->nhdv", K, v / s)
    Z = 1.0 / (torch.einsum("nlhd,nhd->nlh", Q, K.sum(dim=1)) + eps)
    return torch.einsum("nlhd,nhdv,nlh->nlhv", Q, KV, Z) * s


def _pool(x, p):
    B, H, W, C = x.shape
    return x.reshape(B, H // p, p, W // p, p, C).mean(dim=(2, 4))


class ClassTransformerLayer(nn.Module):
    def __init__(self, C, nheads, pooling):
        super().__init__()
        self.norm1 = LayerNorm(C)
        self.q, self.k, self.v = Dense(2 * C, C), Dense(2 * C, C), Dense(C, C)
        self.norm2 = LayerNorm(C)
        self.mlp_fc1, self.mlp_fc2 = Dense(C, 4 * C), Dense(4 * C, C)
        self.nheads, self.pooling = nheads, pooling

    def forward(self, x, tg):
        B, H, W, C = x.shape
        p = self.pooling
        Hp, Wp = H // p, W // p
        tok = _pool(x, p).reshape(B * Hp * Wp, 1, C)
        t = self.norm1(tok)
        g = tg[:, None, :].expand(B, Hp * Wp, C).reshape(B * Hp * Wp, 1, C)
        qk = torch.cat([t, g], dim=-1)
        hd = C // self.nheads
        q = self.q(qk).reshape(-1, 1, self.nheads, hd)
        k = self.k(qk).reshape(-1, 1, self.nheads, hd)
        v = self.v(t).reshape(-1, 1, self.nheads, hd)
        tok = tok + linear_attention(q, k, v).reshape(-1, 1, C)
        tok = tok + self.mlp_fc2(F.relu(self.mlp_fc1(self.norm2(tok))))
        return x + resize2d(tok.reshape(B, Hp, Wp, C), (H, W), "linear", True)


class AggregatorLayer(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        C, g = c["hidden_dim"], c["appearance_proj_dim"]
        self.guidance_norm = LayerNorm(g)
        self.swin_block1 = GuidedSwinBlock(C, g, c["nheads"], c["window"], 0)
        self.swin_block2 = GuidedSwinBlock(C, g, c["nheads"], c["window"], c["window"] // 2)
        self.class_transformer = ClassTransformerLayer(C, c["nheads"], c["pooling"])

    def forward(self, x, app, tg):
        g = self.guidance_norm(app)
        return self.class_transformer(self.swin_block2(self.swin_block1(x, g), g), tg)


class ImageTextFusion(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.clip_conv = Dense(c["clip_dim"], c["clip_proj_dim"], low=False)
        self.conv1 = Conv(c["num_prompts"], c["hidden_dim"], 7, padding=3)
        self.guidance_projection = Conv(c["appearance_guidance_dim"],
                                        c["appearance_proj_dim"], 3, padding=1)
        self.text_guidance_projection = Dense(c["text_guidance_dim"],
                                              c["text_guidance_proj_dim"])
        self.num_layers = c["num_layers"]
        for i in range(self.num_layers):
            self.add_module(f"layer_{i}", AggregatorLayer(c))

    def forward(self, img, txt, app):
        img = self.clip_conv(img)
        txt_n = txt / torch.clamp(torch.linalg.norm(txt, dim=-1, keepdim=True), min=1e-8)
        x = self.conv1(torch.einsum("bhwc,bpc->bhwp", unit(img), txt_n))
        guide = F.relu(self.guidance_projection(app))
        tg = F.relu(self.text_guidance_projection(unit(txt.mean(dim=1))))
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x, guide, tg)
        return x


# ---------------------------------------------------------------- decoder

class DoubleConv(nn.Module):
    def __init__(self, i, o):
        super().__init__()
        self.conv1 = Conv(i, o, 3, padding=1, bias=False)
        self.gn1 = GroupNorm(o // 16, o)
        self.conv2 = Conv(o, o, 3, padding=1, bias=False)
        self.gn2 = GroupNorm(o // 16, o)

    def forward(self, x):
        return F.relu(self.gn2(self.conv2(F.relu(self.gn1(self.conv1(x))))))


class Up(nn.Module):
    def __init__(self, i, up, guid, o):
        super().__init__()
        self.up = ConvTranspose(i, up, 2)
        self.conv = DoubleConv(up + guid, o)

    def forward(self, x, guidance):
        x = self.up(x)
        if guidance is not None:
            x = torch.cat([x, guidance], dim=-1)
        return self.conv(x)


class StandardDecoder(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        g0, g1 = c["guidance_output_dims"]
        for i, (gi, go) in enumerate(zip(c["guidance_input_dims"], (g0, g1))):
            self.add_module(f"guidance_proj_{i}", Conv(gi, go, 3, padding=1))
        d0, d1 = c["decoder_dims"]
        self.decoder1 = Up(c["input_dim"], c["input_dim"] - g0, g0, d0)
        self.decoder2 = Up(d0, d0 - g1, g1, d1)
        self.decoder3 = Up(d1, d1, 0, d1)
        self.head = Conv(d1, 1, 3, padding=1, low=False)

    def forward(self, x, guidance):
        x = self.decoder1(x, F.relu(self.guidance_proj_0(guidance[1])))
        x = self.decoder2(x, F.relu(self.guidance_proj_1(guidance[2])))
        featmap = self.decoder3(x, None)
        return self.head(featmap)[..., 0], featmap


# ---------------------------------------------------------------- Oryon

class Outputs(NamedTuple):
    featmap_a: torch.Tensor   # [B, FH, FW, C]
    featmap_q: torch.Tensor
    mask_a: torch.Tensor      # [B, FH, FW] logits
    mask_q: torch.Tensor


class Oryon(nn.Module):
    """The model of a configuration file's ``model`` section."""

    def __init__(self, cfg: dict):
        super().__init__()
        m = cfg["model"]
        self.clip_size, self.swin_size = m["vision"]["image_size"], m["swin_image_size"]
        self.vlm_visual = ClipVisionTower(m["vision"], m["quant"] == "int8")
        self.vlm_text = ClipTextTower(m["text"])
        self.guidance = SwinGuidance(m["swin"])
        self.fusion = ImageTextFusion(m["fusion"])
        self.decoder = StandardDecoder(m["decoder"])

    def set_precision(self, prec: Prec) -> "Oryon":
        for mod in self.modules():
            if hasattr(mod, "prec"):
                mod.prec = prec
        return self

    def encode_prompts(self, ids: torch.Tensor) -> torch.Tensor:
        """[B, P, L] token ids -> [B, P, D]."""
        B, P, L = ids.shape
        return self.vlm_text(ids.reshape(B * P, L)).reshape(B, P, -1)

    def clip_tower(self, rgb2: torch.Tensor) -> torch.Tensor:
        """uint8 RGB [N, H, W, 3] -> CLIP patch tokens [N, g, g, width]."""
        s = self.clip_size
        return self.vlm_visual(_normalize(resize2d(rgb2.float() / 255.0, (s, s), "cubic", False),
                                          CLIP_MEAN, CLIP_STD))

    def swin_tower(self, rgb2: torch.Tensor):
        """uint8 RGB [N, H, W, 3] -> the Swin taps [g1, g2, g3]."""
        sw = self.swin_size
        return self.guidance(_normalize(resize2d(rgb2.float() / 255.0, (sw, sw), "cubic", True),
                                        IMAGENET_MEAN, IMAGENET_STD))

    def head(self, visual, guid, text) -> Outputs:
        """Fusion and decoder over both views' tower outputs (anchors first)
        and the prompt embeddings [B, P, D] of the pairs."""
        B = text.shape[0]
        logits, feat = self.decoder(self.fusion(visual, torch.cat([text, text]), guid[0]), guid)
        return Outputs(feat[:B], feat[B:], logits[:B], logits[B:])

    def forward(self, rgb_a: torch.Tensor, rgb_q: torch.Tensor,
                text: torch.Tensor) -> Outputs:
        """uint8 RGB [B, H, W, 3] of both views and prompt embeddings [B, P, D]."""
        rgb2 = torch.cat([rgb_a, rgb_q])
        return self.head(self.clip_tower(rgb2), self.swin_tower(rgb2), text)


def build(cfg: dict, device, prec: Optional[Prec] = None) -> Oryon:
    """The reference model with uninitialised parameters on ``device``."""
    with torch.device(device):
        model = Oryon(cfg)
    model.to(device)   # buffers made from numpy
    return model.set_precision(prec or Prec()).eval()

