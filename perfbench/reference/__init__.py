"""Plain references of the served model and its solvers.

``pose.py`` is the pose reference of every configuration (lifting, K2's
distances, PointDSC, ICP).  The model reference is chosen by the
configuration: ``perfbench/reference/<name>.py`` for its optional
``"reference"`` key, ``model.py`` without one (``lib/common.reference``; a
name with no file stops the run).  So a configuration of another
architecture is added with two new files, its configuration and its
reference module, and no edit of a file the harness has.

A model reference module keeps this contract, which ``traffic/serve_closed.py``
(the weights' structure and the comparison), ``control.py``,
``counts/model.py`` and ``spans.py`` rely on:

- ``Oryon(cfg)``: the model of the configuration's ``model`` section, built
  on whatever device is current (``meta`` included: buffers made from numpy
  are moved by ``build``), with
  ``clip_tower(rgb2)`` (uint8 RGB [N, H, W, 3] -> patch tokens [N, g, g,
  width]), ``swin_tower(rgb2)`` (-> the Swin taps [g1, g2, g3]),
  ``encode_prompts(ids)`` ([B, P, L] token ids -> [B, P, D]),
  ``head(visual, guid, text)`` (both views' tower outputs, anchors first,
  and the prompt embeddings -> ``Outputs(featmap_a, featmap_q, mask_a,
  mask_q)``) and ``forward(rgb_a, rgb_q, text)``, as
  ``lib/serve_check.model_numbers`` and ``control.control_numbers`` call
  them and as ``counts/model.py`` counts the forward's FLOPs;
- ``build(cfg, device, prec=None)``: that model on ``device`` in eval mode,
  its low-precision products set by ``prec``; and ``Prec(control=False)``,
  whose ``control=True`` rounds those operands one step lower and whose
  ``low(t)`` rounds one operand so;
- parameter names equal to the served model's, so that one state dict
  loads strictly into both;
- layers built from ``model.py``'s ``Dense``, ``Conv`` and ``LayerNorm``
  (and the other classes ``lib/weights.py`` names), so that its rule draws
  their weights from the seed as it draws the served model's.

The program's side is built by ``traffic/serve_closed.build_program``,
which hands the configuration's ``vision`` and ``text`` sections whole to
the port's ``ClipVisionConfig`` and ``ClipTextConfig``: a later tower is
chosen there by keys of those sections that the port's config classes
accept.
"""
