"""render_rays_per_s: the pixels of every view whose maps reached the host in the window
over the window's seconds."""


def read(w):
    return w.rays / w.window_s if w.kind in ("view", "mani") else None
