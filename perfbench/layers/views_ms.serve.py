"""Host time of the engine's views in a served request: the program's span
``engine.views`` (the PIL resizes, stacking and copies to the card of both
views of every pair), ms a request over the window of a traced run, whose
requests run with spans on."""


def read(data, cell):
    s = data.get("spans")
    return s["ms"].get("engine.views") if s else None
