"""Host-blocking synchronisations of a served request (stream, device and
event synchronisations, blocking copies) under the program's
``engine.request`` span, every layer's together (``solver_syncs`` splits
out the solvers'), from the requests a traced run profiles with the
host's activity and spans on; nothing where the profile saw no device."""


def read(data, cell):
    s = data.get("spans")
    if not s or not s["counts"]["kernels"]:
        return None
    return s["counts"]["request"]["syncs"]
