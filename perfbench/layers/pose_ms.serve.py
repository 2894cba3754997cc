"""Device time of the solvers in a served request: the pipeline's ``solve``
(lifting, PointDSC) and ``icp`` stages by their CUDA events; mean."""
import statistics


def read(data, cell):
    ms = [s["pose"] for s in data.get("stage_ms") or []]
    return statistics.fmean(ms) if ms else None
