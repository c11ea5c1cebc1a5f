"""glue_ms_per_step.train: device ms a traced step of every activity that no role claims:
the pipeline's sampling and compositing, the losses, the optimizer, copies and fills."""


def read(t):
    steps = t.work.get("steps")
    return 1e3 * t.role_seconds(None) / steps if steps and t.device else None
