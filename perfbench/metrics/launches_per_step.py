"""Device kernels launched per training step (train/trainer.LyapunovTrainer
._train_step), counted in the profiled slice."""


def read(ctx):
    p = ctx.profile
    if p is None or not p.kernels():
        return None
    return len(p.kernels()) / p.iterations
