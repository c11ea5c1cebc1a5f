"""chunk_idle_share.render: the device's idle time while a ``render.chunk`` or ``mani.chunk``
span of the program is open (the renderers' chunk loops), over the traced window, in %."""

from benchmark.spans import idle_share_in


def read(t):
    return idle_share_in(t, ["render.chunk", "mani.chunk"])
