"""The EVA02 cell, ``serve-eva02-bf16-b8``, at a tiny size on the CPU: a run
comes out correct; faults planted in the served EVA02 towers make it not
correct; the new readers read what they should and nothing where the
program lacks what they read; the cell reports the ``.serve`` metrics, and
the FLOPs behind its ``mfu.serve`` hold the SwiGLU's three products."""
import pytest
import torch

from perfbench import run as run_mod
from perfbench.counts import kernels, model as model_counts, peaks, rope
from perfbench.lib import common
from perfbench.tests.tiny import tiny_cell

CELL = "serve-eva02-bf16-b8"
SEED = 2 ** 31 + 4246
NEW = ("rope_roofline.eva", "vision_launches.eva")


def tiny_eva_cell() -> dict:
    """``tiny.tiny_cell`` of the EVA02 cell with the EVA02 keys of its
    configuration put back on the tiny towers (SwiGLU hidden int(64 x
    2.6667) = 170)."""
    cell = tiny_cell(CELL)
    m = cell["config"]["model"]
    m["vision"]["block"] = "eva02"
    m["text"]["act"] = "gelu"
    return cell


def _run(trace=False):
    line, checks = run_mod.run_cell(tiny_eva_cell(), SEED, 1.0, trace, device="cpu")
    return line, {c["name"]: c for c in checks}


@pytest.mark.parametrize("trace", [False, True])
def test_tiny_eva_cell_is_correct(trace):
    line, checks = _run(trace)
    assert line["correct"], checks
    assert all(c["ok"] for c in checks.values())
    if trace:
        assert "mfu.serve" in line["metrics"]
    else:
        assert {"serve_pairs_per_s", "setup_s"} <= set(line["metrics"])


def _class_row_rotated(monkeypatch):
    """The rotation of rows 0..L-2 with the tables of rows 1..L-1: the class
    token rotated, every patch token by its neighbour's angles."""
    from oryon_tpu_torch.models import clip
    from oryon_tpu_torch.ops.cuda.rope import rotate_plain

    def shifted(qkv, cos, sin, heads):
        B, L, C3 = qkv.shape
        C = C3 // 3
        qk = qkv[:, :L - 1, :2 * C].reshape(B, L - 1, 2 * heads, C // heads)
        qkv[:, :L - 1, :2 * C] = rotate_plain(qk, cos[:, None], sin[:, None]).reshape(
            B, L - 1, 2 * C)
        return qkv

    monkeypatch.setattr(clip, "rope_qk_", shifted)


def _halves_swapped(monkeypatch):
    """Row angles on the second half of each head, column angles on the first."""
    from oryon_tpu_torch.models import clip
    real = clip.rope_tables

    def swapped(head_dim, grid, pt_grid):
        h = head_dim // 2
        return tuple(t[:, list(range(h, head_dim)) + list(range(h))].copy()
                     for t in real(head_dim, grid, pt_grid))

    monkeypatch.setattr(clip, "rope_tables", swapped)


def _sub_ln_skipped(monkeypatch):
    from oryon_tpu_torch.models import clip
    real = clip.EvaAttention.forward

    def skipped(self, x, rope_tables):
        ln = self.inner_attn_ln
        self.inner_attn_ln = torch.nn.Identity()
        try:
            return real(self, x, rope_tables)
        finally:
            self.inner_attn_ln = ln

    monkeypatch.setattr(clip.EvaAttention, "forward", skipped)


def _quick_gelu_text(monkeypatch):
    from oryon_tpu_torch.models import clip
    monkeypatch.setitem(clip.ACTIVATIONS, "gelu", clip.quick_gelu)


@pytest.mark.parametrize("plant", [_class_row_rotated, _halves_swapped, _sub_ln_skipped])
def test_planted_faults_fail(monkeypatch, plant):
    plant(monkeypatch)
    line, checks = _run()
    assert not line["correct"] and not checks["clip_err"]["ok"], checks


def test_quick_gelu_in_the_text_tower_is_read_but_within_bf16_noise(monkeypatch):
    """QuickGELU in the text tower moves the prompt embeddings by about 1%
    here and 1.0-2.0% at full width on seeded weights, as much as the bf16
    program's own ``text_err`` (PERF.md): the comparison reads it, and no
    limit between the program's and the control's readings can tell it from
    bf16 rounding, so ``correct`` stays true."""
    _quick_gelu_text(monkeypatch)
    line, checks = _run()
    assert 5e-3 < checks["text_err"]["value"] < checks["text_err"]["limit"], checks


def test_new_readers_are_the_cells_and_are_found():
    """The cell reports its two new metrics and every ``.serve`` metric of
    ``serve-int8-b8``, the cell of the same traffic."""
    bench = common.manifest()
    for name in NEW:
        m = next(m for m in bench["per_layer"] if m["name"] == name)
        assert m["workloads"] == [CELL] and m["moves"] == "serve_pairs_per_s"
        assert hasattr(common.layer_reader(name), "read")
    serve = {m["name"] for m in common.cell_metrics("serve-int8-b8", "per_layer", bench)}
    assert serve and all(name.endswith(".serve") for name in serve)
    cell_metrics = {m["name"] for m in common.cell_metrics(CELL, "per_layer", bench)}
    assert cell_metrics == set(NEW) | serve


def _trace_data(rope_kernels, rope_counted, k1=48):
    cell = common.load_cell(CELL)
    launches = {"k1": k1}
    if rope_counted is not None:
        launches["rope"] = rope_counted
    kern = {"void attn_wgmma_kernel<64>(...)": [k1, k1 * 100e-6]}
    if rope_kernels:
        kern["void (anonymous namespace)::rope_qk_kernel<__nv_bfloat16>(...)"] = [
            rope_kernels, rope_kernels * 30e-6]
    return cell, {"trace": {"kernels": kern}, "launches": launches}


def test_rope_roofline_reads_the_kernel_and_holds_its_count():
    reader = common.layer_reader("rope_roofline.eva")
    cell, data = _trace_data(48, 48)
    ops, nbytes = rope.rope(16, 577, 1024, 16)
    # q and k of 16 x 576 rows in bf16, read and written: 75.5 MB; the f32 tables: 0.3 MB
    assert nbytes == 2 * 2 * 16 * 576 * 2048 + 2 * 4 * 576 * 64
    assert ops == 3 * 16 * 576 * 2048
    bound = kernels.bound_s(ops, nbytes, peaks.F32_FLOPS)
    assert bound == pytest.approx(nbytes / peaks.HBM_BYTES_PER_S)
    assert reader.read(data, cell) == pytest.approx(100 * bound / 30e-6)
    with pytest.raises(common.BenchError, match="R1"):
        reader.read(_trace_data(47, 48)[1], cell)
    # a program without R1 (no "rope" count): nothing, and no error
    assert reader.read(_trace_data(0, None)[1], cell) is None
    assert reader.read({"trace": None, "launches": None}, cell) is None


def test_vision_launches_read_the_eva_span():
    reader = common.layer_reader("vision_launches.eva")
    counts = {"requests": 2, "request": {"launches": 1000.0, "syncs": 10.0},
              "graph_launches": 0.0, "graph_kernels": 0.0, "kernels": 1000.0,
              "spans": {"pipeline.forward": {"launches": 300.0, "syncs": 2.0},
                        "vision.eva": {"launches": 420.0, "syncs": 0.0}}}
    assert reader.read({"spans": {"counts": counts}}, None) == 420.0
    del counts["spans"]["vision.eva"]
    assert reader.read({"spans": {"counts": counts}}, None) is None
    assert reader.read({"spans": None}, None) is None


def test_mfu_serve_counts_the_eva_flops_in_the_cell():
    cell = common.load_cell(CELL)
    data = {"requests": 10, "window_s": 50.0}
    flops = model_counts.request_flops(cell["config"], 8) * 10
    assert flops != model_counts.request_flops(common.load_cell("serve-int8-b8")["config"], 8) * 10
    assert common.layer_reader("mfu.serve").read(data, cell) == pytest.approx(
        100 * flops / (50.0 * peaks.BF16_FLOPS))


def eva_vision_flops(image_size, patch, width, layers, hidden):
    """The EVA02 vision tower of one image by hand: the patch convolution,
    then per layer q|k|v, the two attention products, ``proj`` and the
    SwiGLU's three products (w1, w2, w3)."""
    g = image_size // patch
    T = g * g + 1
    per_layer = 2 * T * width * 3 * width + 4 * T * T * width + 2 * T * width * width \
        + 3 * 2 * T * width * hidden
    return 2 * g * g * 3 * patch * patch * width + layers * per_layer


def test_mfu_flops_count_the_swiglu_products():
    from torch.utils.flop_counter import FlopCounterMode

    from perfbench.reference import eva02

    eva_cfg = common.load_cell(CELL)["config"]
    clip_cfg = common.load_cell("serve-int8-b8")["config"]
    v = eva_cfg["model"]["vision"]
    by_hand = eva_vision_flops(336, 14, 1024, 24, 2730)
    with torch.device("meta"):
        tower = eva02.EvaVisionTower(v)
        with FlopCounterMode(display=False) as fc:
            tower(torch.zeros(1, 336, 336, 3))
    assert fc.get_total_flops() == by_hand
    # the rest of a request (Swin, fusion, decoder) is the CLIP cells'
    clip_one = model_counts.clip_vision_flops(336, 14, 1024, 24)
    eva_req = model_counts.request_flops(eva_cfg, 1)
    assert eva_req - 2 * by_hand == model_counts.request_flops(clip_cfg, 1) - 2 * clip_one
    assert model_counts.request_flops(eva_cfg, 8) == pytest.approx(8 * eva_req, rel=1e-6)


def test_the_tiny_cell_keeps_the_cells_keys():
    cell = tiny_eva_cell()
    full = common.load_cell(CELL)
    assert cell["config"]["reference"] == "eva02"
    assert cell["config"]["model"]["vision"]["block"] == full["config"]["model"]["vision"]["block"]
    assert cell["config"]["model"]["text"]["act"] == full["config"]["model"]["text"]["act"]
