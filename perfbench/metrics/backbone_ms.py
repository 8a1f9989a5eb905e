"""Milliseconds of the backbone (models/backbones.KWLargeBackbone with
models/layers and ops/cayley: Normalize, the Cayley transforms, K3, GroupSort,
the Cayley linears) on the cell's batch, between CUDA events around the
benchmark's own calls of ``model.backbone``, apart from the window."""
import torch

from perfbench import harness

ITERS = 3


def read(ctx):
    st = ctx.state
    if st.device.type != "cuda":
        return None
    x = st.pool[0]
    with torch.no_grad():
        return harness.cuda_ms(lambda: st.model.backbone(x), ITERS)
