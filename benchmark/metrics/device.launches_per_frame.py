"""Device kernels a frame launches: the kernels torch.profiler records
on the device over the traced frames, per frame."""


def read(r):
    return r.launches() / r.units if r.units and r.ops else None
