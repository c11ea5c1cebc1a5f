"""host_launches_per_view.render: the host's kernel launches and asynchronous copies
(``cudaLaunchKernel``, ``cuLaunchKernel``, ``cudaMemcpyAsync`` calls) a traced view."""

from benchmark.trace import launches


def read(t):
    views = t.work.get("views")
    return launches(t) / views if views else None
