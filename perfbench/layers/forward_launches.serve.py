"""Kernel-launch calls of a served request in the model's forward: the
program's span ``pipeline.forward`` (the towers, fusion and decoder), from
the requests a traced run profiles with the host's activity and spans on.
Nothing where the profile missed launches (``lib/spans.launches_agree``)."""
from perfbench.lib import spans


def read(data, cell):
    return spans.layer_calls(data, "launches", spans.FORWARD)
