"""Device time of the model's forward (towers, fusion, decoder) in a served
request: the pipeline's ``forward`` stage by its CUDA events; mean."""
import statistics


def read(data, cell):
    ms = [s["forward"] for s in data.get("stage_ms") or []]
    return statistics.fmean(ms) if ms else None
