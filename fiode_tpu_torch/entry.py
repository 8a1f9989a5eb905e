"""Model constructors: the flagship (counterpart of ``__graft_entry__._flagship``
and ``entry``), KWLarge Cayley backbone with GroupSort -> simplex neural-ODE
classifier, dopri5 at rtol = atol = 1e-3 to t = 1; and the certified
configuration (counterpart of ``fiode_tpu.experiment.build_model`` on
``configs/certify/cifar_certify.yaml``), which the attacks run against;
and ``dryrun_multichip`` (counterpart of ``__graft_entry__.dryrun_multichip``),
which runs every parallel path once on n ranks."""
from __future__ import annotations

import math
from typing import Optional

import torch

from .bridge import load_npz
from .models.backbones import KWLargeBackbone
from .models.dynamics import SimplexDynamics
from .models.ivp import NeuralODEClassifier

__all__ = ["flagship", "certify_model", "entry", "dryrun_multichip",
           "CIFAR_MU", "CIFAR_STD"]

CIFAR_MU = (0.485, 0.456, 0.406)
CIFAR_STD = (0.225, 0.225, 0.225)


def flagship(n_classes: int = 10, mlp_size: int = 128,
             generator: Optional[torch.Generator] = None,
             device: str = "cuda") -> NeuralODEClassifier:
    """The flagship classifier in eval mode on ``device``.  Its weights are
    drawn from ``generator`` on the CPU and then moved, so a seed gives the
    same weights on every device."""
    dyn = _flagship_dynamics(generator, n_classes, mlp_size)
    backbone = KWLargeBackbone(out_dim=n_classes, act="GroupSort",
                               mu=CIFAR_MU, std=CIFAR_STD,
                               generator=generator)
    model = NeuralODEClassifier(
        backbone=backbone, dynamics=dyn, t_max=1.0,
        rtol=1e-3, atol=1e-3,
    )
    return model.eval().to(device)


def _flagship_dynamics(generator, n_classes: int = 10,
                       mlp_size: int = 128) -> SimplexDynamics:
    return SimplexDynamics(
        n_hidden=n_classes, mlp_size=mlp_size, x_dim=n_classes, dropout=0.5,
        alpha_1=100.0, alpha_2=20.0, sigma_1=0.02, scale_nominal=True,
        generator=generator)


def certify_model(t_max: float = 1.0, max_steps: int = 64,
                  generator: Optional[torch.Generator] = None,
                  device: str = "cuda",
                  checkpoint=None) -> NeuralODEClassifier:
    """The cifar_certify configuration: KWLarge GroupSort backbone to 10
    features, ReLU simplex dynamics (mlp 128, alpha_1 = 100, sigma_1 = 0.02,
    alpha_2 = 20, scale_nominal off), dopri5 at rtol = atol = 1e-3 to
    ``t_max`` within ``max_steps`` attempted steps.  In eval mode on
    ``device``, weights drawn from ``generator`` on the CPU, then moved;
    ``checkpoint``, the path of a flat ``.npz`` (``bridge.load_npz``, e.g.
    ``run_data/certified_full/ckpt/best_torch.npz``), replaces them with
    trained ones."""
    dyn = SimplexDynamics(
        n_hidden=10, mlp_size=128, x_dim=10, activation="ReLU", dropout=0.5,
        alpha_1=100.0, alpha_2=20.0, sigma_1=0.02, scale_nominal=False,
        generator=generator,
    )
    backbone = KWLargeBackbone(out_dim=10, act="GroupSort", mu=CIFAR_MU,
                               std=CIFAR_STD, generator=generator)
    model = NeuralODEClassifier(
        backbone=backbone, dynamics=dyn, t_max=t_max, rtol=1e-3, atol=1e-3,
        max_steps=max_steps,
    )
    if checkpoint is not None:
        load_npz(model, checkpoint)
    return model.eval().to(device)


def entry(device: str = "cuda"):
    """(fn, example_args): the flagship's forward pass on 8 blank images on
    ``device``, weights from seed 0."""
    model = flagship(generator=torch.Generator().manual_seed(0), device=device)
    x = torch.zeros((8, 3, 32, 32), device=device)
    return model.predict, (x,)


# ---------------------------------------------------------------------------
# the multi-chip dry run (counterpart of __graft_entry__.dryrun_multichip)


def dryrun_multichip(n_devices: int, device: str = "cuda") -> dict:
    """Every parallel path once, on ``n_devices`` ranks of a
    ``torch.distributed`` group started here (``torch.multiprocessing``,
    spawn), each rank on its own card, or on the CPU with ``device="cpu"``:

      1. one data-parallel Lyapunov step of the flagship dynamics on a
         TinyMLP backbone (hidden 32), batch 2 n, every rank's part of the
         global batch's draws (``parallel/multihost.py``), the gradients
         all-reduced; the parameters after it equal on every rank;
      2. the same step with the KWLarge backbone on 16 x 16 crops;
      3. one CROWN + ``ibp_cbf_qp`` + ``worst_case_vdot`` chunk of 8 n
         cells split over a ``Mesh`` of n entries, equal to the unsharded
         chunk;
      4. for n >= 2 the ``Certifier`` on a 2 x (n // 2) ("img", "cell")
         mesh (3 classes, mlp 16, T 8, the images labelled as the model
         predicts them) and ``refine_uncertified`` on it (frontier_cap 256,
         box_budget 2048), verdicts, worst values and refinement
         statistics equal to the unsharded ones;
      5. APGD-CE (L2 36/255, 3 iterations) through the step's tiny model
         at t_max 0.1 within 4 solver steps, each rank on its rows of the
         batch (``shard_rows``).

    Parts 3 and 4 run on rank 0, whose mesh holds the ranks' devices.  With
    more ranks than cards the ranks share the cards and the group is gloo
    over their CUDA tensors (NCCL refuses two ranks on one card); NCCL
    otherwise.  Prints ``dryrun_multichip(n) OK`` and returns rank 0's
    report.  ``device="cuda"`` without a card raises; nothing moves to the
    CPU unasked."""
    import json
    import socket
    import tempfile
    from pathlib import Path

    import torch.multiprocessing as mp

    if n_devices < 1:
        raise ValueError(f"dryrun_multichip needs n_devices >= 1, got {n_devices}")
    kind = torch.device(device).type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("dryrun_multichip(device='cuda'): no CUDA device "
                               "is available (device='cpu' runs on the CPU)")
        backend = "nccl" if n_devices <= torch.cuda.device_count() else "gloo"
    elif kind == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"dryrun_multichip runs on cuda or cpu, not {device!r}")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory() as td:
        mp.start_processes(_dryrun_rank, args=(n_devices, kind, backend, port, td),
                           nprocs=n_devices, start_method="spawn")
        report = json.loads((Path(td) / "report.json").read_text())
    print(f"dryrun_multichip({n_devices}) OK", flush=True)
    return report


def _dryrun_rank(rank, n, kind, backend, port, out_dir):
    import json
    import os
    from pathlib import Path

    import torch.distributed as dist

    if kind == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        mesh_devs = [torch.device("cuda", i % torch.cuda.device_count())
                     for i in range(n)]
    else:
        dev = torch.device("cpu")
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
        mesh_devs = [dev] * n
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=n, rank=rank)
    try:
        report = _dryrun_work(rank, n, dev, mesh_devs, Path(out_dir))
        if rank == 0:
            report["backend"] = backend
            (Path(out_dir) / "report.json").write_text(json.dumps(report))
    finally:
        dist.destroy_process_group()


def _same_on_every_rank(value: float) -> bool:
    import torch.distributed as dist

    t = torch.tensor([value, -value], dtype=torch.float64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t[0] == -t[1])


def _dryrun_step(model, xs, ys, dev, run_dir):
    """One data-parallel Lyapunov step on this rank's rows of the global
    batch (xs, ys): (loss, parameter checksum)."""
    import numpy as np

    from .parallel.multihost import process_rows
    from .train.data import Dataset
    from .train.schedulers import CompositeSamplerScheduler, LinearScheduler
    from .train.trainer import LyapunovTrainer, TrainConfig

    B = len(xs)
    ds = Dataset("CIFAR10", xs, ys, xs, ys, xs, ys, 10)
    cfg = TrainConfig(batch_size=B, val_batch_size=B, h_sample_size=4,
                      max_epochs=1, log_every=1000, augment=False)
    sch = CompositeSamplerScheduler(
        [LinearScheduler(rate=-0.02, bias=1.0), LinearScheduler(rate=0.02)],
        [1.0, 1.0])
    tr = LyapunovTrainer(model, cfg, ds, scheduler=sch, run_dir=str(run_dir),
                         device=dev)
    tr.reset_optimizer(False)
    rows = torch.arange(B)[process_rows(B)].to(dev)
    loss, _ = tr._train_step(tr._train_x[rows], tr._train_y[rows], 0,
                             np.asarray([0.5, 0.5], np.float32), 0.0, True)
    loss = float(loss)
    if not math.isfinite(loss):
        raise RuntimeError(f"the data-parallel step's loss is {loss}")
    checksum = float(sum(p.detach().double().sum().cpu() for p in model.parameters()))
    if not _same_on_every_rank(checksum):
        raise RuntimeError("the parameters differ between ranks after the step")
    return loss, checksum


def _crown_chunk(Ws, bs, eta, x_bias):
    from .verify.crown import crown_mlp_bounds
    from .verify.ibp_qp import ibp_cbf_qp, worst_case_vdot

    lb, ub = crown_mlp_bounds(Ws, bs, eta, 1.0 / 40, x_bias)
    f_lb, f_ub = ibp_cbf_qp(eta, 1.0 / 40, lb, ub, 100.0, 0.02, 20.0)
    return worst_case_vdot(eta, 1.0 / 40, f_lb, f_ub, 0).max()


def _dryrun_work(rank, n, dev, mesh_devs, out_dir) -> dict:
    import numpy as np
    import torch.distributed as dist

    from .attacks.apgd import apgd_ce
    from .experiment import BudgetedForward
    from .models.backbones import TinyMLPBackbone
    from .parallel.multihost import shard_rows
    from .train.trainer import frozen
    from .utils.tracing import counters

    report = {"n_devices": n}
    B = 2 * n
    rng = np.random.default_rng(0)
    xs = rng.uniform(0, 1, (4 * B, 3, 32, 32)).astype(np.float32)[:B]
    ys = rng.integers(0, 10, 4 * B).astype(np.int32)[:B]
    run_dir = out_dir / f"rank{rank}"

    # 1. the tiny model's data-parallel step
    g = torch.Generator().manual_seed(0)
    model = NeuralODEClassifier(
        backbone=TinyMLPBackbone(3 * 32 * 32, out_dim=10, hidden=32,
                                 mu=CIFAR_MU, std=CIFAR_STD, generator=g),
        dynamics=_flagship_dynamics(g), t_max=1.0, rtol=1e-3, atol=1e-3)
    report["tiny_loss"], report["tiny_checksum"] = _dryrun_step(
        model, xs, ys, dev, run_dir)

    # 2. KWLarge at 16 x 16 crops
    g = torch.Generator().manual_seed(7)
    kw = NeuralODEClassifier(
        backbone=KWLargeBackbone(out_dim=10, act="GroupSort", mu=CIFAR_MU,
                                 std=CIFAR_STD, img_size=16, generator=g),
        dynamics=_flagship_dynamics(g), t_max=1.0, rtol=1e-3, atol=1e-3)
    report["kwlarge_loss"], _ = _dryrun_step(
        kw, np.ascontiguousarray(xs[:, :, :16, :16]), ys, dev, run_dir)

    if rank == 0:
        report.update(_dryrun_mesh(model, n, dev, mesh_devs))
    dist.barrier()

    # 5. APGD-CE on this rank's rows
    model.eval()
    model.t_max, model.max_steps = 0.1, 4
    x_all = torch.from_numpy(xs).to(dev)
    y_all = torch.from_numpy(ys).long().to(dev)
    xa, ya = shard_rows(lambda m: (x_all[:m], y_all[:m]), B // n, (rank, n))
    forward = BudgetedForward(model)
    with frozen(model):
        x_adv, success = apgd_ce(forward, xa, ya, eps=36 / 255, norm="L2",
                                 n_iter=3, generator=torch.Generator(dev).manual_seed(3))
    if not torch.isfinite(x_adv).all():
        raise RuntimeError("APGD-CE returned a non-finite adversarial")
    report["apgd_rows"] = len(xa)
    report["apgd_success"] = int(success.sum())
    report["apgd_max_attempts"] = forward.max_attempts
    launches = counters()
    report["launches"] = {f"k{i}.launches": launches.get(f"k{i}.launches", 0)
                          for i in range(1, 6)}
    return report


def _dryrun_mesh(model, n, dev, mesh_devs) -> dict:
    """Parts 3 and 4 on rank 0: the CROWN chunk and the Certifier with
    refinement on meshes of ``mesh_devs``, each against the unsharded run."""
    import numpy as np

    from .models.backbones import TinyMLPBackbone
    from .models.dynamics import densify_dynamics_params
    from .parallel.mesh import Mesh
    from .verify.certify import Certifier, float32_matmuls
    from .verify.refine import refine_uncertified

    out = {}
    # 3. a CROWN chunk, its cells split over the mesh
    with torch.no_grad(), float32_matmuls():
        dense = densify_dynamics_params(model.dynamics)
        Ws, bs = zip(*(dense[k] for k in ("hidden_to_mlp", "mlp_to_mlp",
                                          "mlp_to_hidden")))
        eta = torch.randn(8 * n, 10, generator=torch.Generator().manual_seed(2)).abs()
        eta = (eta / eta.sum(-1, keepdim=True)).to(dev)
        x_bias = torch.zeros(Ws[0].shape[0], device=dev)
        whole = float(_crown_chunk(Ws, bs, eta, x_bias))
        mesh = Mesh(mesh_devs, ("cell",))
        parts = [float(_crown_chunk([w.to(d) for w in Ws], [b.to(d) for b in bs],
                                    piece.to(d), x_bias.to(d)))
                 for d, piece in zip(mesh.devices.reshape(-1),
                                     torch.tensor_split(eta, n))]
    if max(parts) != whole:
        raise RuntimeError(f"the sharded CROWN chunk's max {max(parts)} is not "
                           f"the unsharded {whole}")
    out["crown_chunk_max"] = whole
    if n < 2:
        return out

    # 4. the Certifier and refinement on a 2-D ("img", "cell") mesh
    g = torch.Generator().manual_seed(6)
    cmodel = NeuralODEClassifier(
        backbone=TinyMLPBackbone(64, out_dim=6, hidden=16, mu=(0.5,),
                                 std=(0.25,), generator=g),
        dynamics=SimplexDynamics(n_hidden=3, mlp_size=16, x_dim=6, dropout=0.0,
                                 alpha_1=100.0, alpha_2=20.0, sigma_1=0.02,
                                 generator=g),
        n_classes=3).eval().to(dev)
    cx = torch.rand(4, 1, 8, 8, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():  # labels the model predicts: every image is clean
        cy = cmodel.predict(cx.to(dev)).argmax(-1).cpu().numpy()
    half = n // 2
    mesh2 = Mesh(np.asarray(mesh_devs[:2 * half], dtype=object).reshape(2, half),
                 ("img", "cell"))
    chunk = 4 * half
    runs = {}
    for name, m in (("unsharded", None), ("mesh", mesh2)):
        cert = Certifier(cmodel, T=8, eps_input=0.1, chunk=chunk, mesh=m)
        res = cert.certify(cx, cy, method="crown", early_exit=True)
        refined, stats = refine_uncertified(
            cert, cx, cy, res.certified, clean=res.clean, chunk=chunk,
            superchunk=2, max_rounds=2, frontier_cap=256, box_budget=2048)
        runs[name] = {
            "clean": res.clean.tolist(), "certified": res.certified.tolist(),
            "worst": [float(w) for w in res.worst],
            "refined": refined.tolist(),
            "refine_stats": [(s.image, s.base_violated, s.rounds,
                              s.boxes_evaluated, s.certified, s.gave_up)
                             for s in stats]}
    a, b = runs["mesh"], runs["unsharded"]
    if not (all(a[k] == b[k] for k in a if k != "worst")
            and np.array_equal(a["worst"], b["worst"], equal_nan=True)):
        raise RuntimeError(f"the certification mesh differs from the unsharded "
                           f"run: {runs}")
    out["certify"] = runs
    return out
