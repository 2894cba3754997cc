"""Host time of a served request outside the pipeline's device work: the
benchmark's clock around ``predict`` less the span of the request's stage
events (first to last); mean over the unprofiled requests of a traced run.
It holds the engine's resizes, stacking, copies and the result's fetch."""
import statistics


def read(data, cell):
    return statistics.fmean(data["host_ms"]) if data.get("host_ms") else None
