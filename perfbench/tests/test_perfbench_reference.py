"""The model reference named by a configuration (``lib/common.reference``):
a probe module named by a tiny cell's configuration is what every user of
the reference builds; an explicit ``"reference": "model"`` is no key at
all; a name without a file stops the run; the FLOPs behind ``mfu.*`` are
the numbers they were before the reference became the configuration's."""
import os
import sys
import time
import types

import pytest
import torch

from perfbench import control, run as run_mod, spans as spans_script
from perfbench.counts import model as model_counts
from perfbench.lib import common
from perfbench.reference import model as ref_model
from perfbench.tests.tiny import tiny_cell
from perfbench.traffic import serve_closed

SEED = 2 ** 31 + 4245
PROBE = "probe_ref"


def _probe():
    """(a reference module whose ``Oryon`` is ``model.Oryon`` noting where
    it is built, the places noted: (file, function) of the first frame
    outside this file)."""
    places = set()

    class Oryon(ref_model.Oryon):
        def __init__(self, cfg):
            super().__init__(cfg)
            f = sys._getframe(1)
            while f.f_code.co_filename == __file__:
                f = f.f_back
            places.add((os.path.basename(f.f_code.co_filename), f.f_code.co_name))

    def build(cfg, device, prec=None):
        with torch.device(device):
            model = Oryon(cfg)
        model.to(device)
        return model.set_precision(prec or ref_model.Prec()).eval()

    mod = types.ModuleType(f"perfbench.reference.{PROBE}")
    mod.Oryon, mod.build, mod.Prec = Oryon, build, ref_model.Prec
    return mod, places


def test_a_configuration_reaches_its_named_reference_at_every_place(monkeypatch):
    probe, places = _probe()
    monkeypatch.setitem(sys.modules, probe.__name__, probe)
    cell = tiny_cell("serve-bf16-b1")
    cell["config"]["reference"] = PROBE
    assert common.reference(cell["config"]) is probe
    model_counts._request_flops.cache_clear()
    data = serve_closed.run(cell, SEED, 0.0, True, time.perf_counter(), device="cpu",
                            on_card=False, keep=True)
    data["seed"] = SEED
    line = run_mod.result_line(cell, data, True, common.manifest(), torch)     # mfu.tail
    assert line["metrics"]["mfu.tail"]["value"] > 0
    control.control_numbers(cell, data, "cpu")
    spans_script.measure(cell, SEED, 0.0, 0, device="cpu")
    assert places == {("serve_closed.py", "run"), ("serve_closed.py", "compare"),
                      ("control.py", "control_numbers"), ("model.py", "_request_flops"),
                      ("spans.py", "set_up")}


def test_an_explicit_model_reference_is_no_key():
    checks = []
    for key in ({}, {"reference": "model"}):
        cell = tiny_cell("serve-bf16-b1")
        cell["config"].update(key)
        data = serve_closed.run(cell, SEED, 0.0, False, time.perf_counter(), device="cpu",
                                on_card=False, keep=True)
        checks.append(data["checks"])
    assert checks[0] == checks[1] and checks[0]


# FLOPs of a request at each cell's batch, as counts/model.py gave them
# while it built reference/model.py by name
REQUEST_FLOPS = {"serve-int8-b8": 6_495_552_897_024, "serve-bf16-b1": 811_944_112_128}


@pytest.mark.parametrize("name", sorted(REQUEST_FLOPS))
def test_request_flops_are_unchanged(name):
    cell = common.load_cell(name)
    cfg, B = cell["config"], cell["workload"]["batch"]
    assert "reference" not in cfg
    assert model_counts.request_flops(cfg, B) == REQUEST_FLOPS[name]
    assert model_counts.request_flops(dict(cfg, reference="model"), B) == REQUEST_FLOPS[name]


@pytest.mark.parametrize("name", ["no_such_reference", "../model", "model.sub"])
def test_a_reference_without_a_file_stops_the_run(name):
    with pytest.raises(common.BenchError, match="reference"):
        common.reference({"reference": name})
    cell = tiny_cell("serve-bf16-b1")
    cell["config"]["reference"] = name
    with pytest.raises(common.BenchError):
        run_mod.run_cell(cell, SEED, 0.0, False, device="cpu")
