"""kernels_per_step: device operations (kernels, copies and sets; no
annotation ranges) per profiled step."""


def read(run):
    p = run.profile
    if not p or not p.steps or not p.device_events:
        return None
    return p.device_events / p.steps
