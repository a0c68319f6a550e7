"""Device kernels launched in the traced slice, per batch served in it."""


def read(rec):
    return len(rec.kernels) / len(rec.batches) if rec.batches else None
