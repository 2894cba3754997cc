"""Share of the card's bf16 peak that the served requests' model FLOPs make
up over the run's window: FLOPs of a request (``counts/model.py``) times the
requests answered, over the window's seconds times the peak, %."""
from perfbench.counts import model, peaks


def read(data, cell):
    if not data.get("requests"):
        return None
    flops = model.request_flops(cell["config"], cell["workload"]["batch"]) * data["requests"]
    return 100.0 * flops / (data["window_s"] * peaks.BF16_FLOPS)
