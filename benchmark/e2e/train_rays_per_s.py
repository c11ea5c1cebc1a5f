"""train_rays_per_s: N_train x the train steps completed in the window over the window's
seconds. A pack counts once its losses are on the host."""


def read(w):
    return w.rays / w.window_s if w.kind == "train" else None
