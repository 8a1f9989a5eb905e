#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (fiode_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the two hand-written CUDA kernels from fiode_tpu_torch/csrc, holds
each against its plain PyTorch version at the flagship's shapes, drives the
flagship forward solve (KWLarge Cayley backbone -> simplex neural ODE,
dopri5) through the kernels and through the plain path, checks that the
kernels carried the solve, and times both.  No phase catches its own
failure.  Without a CUDA device it exits non-zero and prints no result.

The second-to-last line of stdout is a JSON object describing each kernel,
the last line the contract object
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import torch

ROOT = Path(__file__).resolve().parent
SEED = 0
N_CLASSES, MLP = 10, 128
K1_BATCH, K3_BATCH, E2E_BATCH, TIME_BATCH = 4096, 64, 4096, 32768
K1_TOL, K3_TOL, E2E_TOL = 2e-4, 1e-4, 1e-3
# (ci, co, k, n) of the flagship's four CayleyConv applies (after
# space_to_depth for the strided ones)
CONV_SHAPES = ((3, 32, 3, 32), (128, 32, 2, 16), (32, 64, 3, 16),
               (256, 64, 2, 8))


def log(msg: str) -> None:
    print(msg, flush=True)


def gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device milliseconds per call of ``fn`` (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs on a GPU")
    if not (ROOT / "fiode_tpu_torch" / "csrc").is_dir():
        raise SystemExit(f"chip_smoke: no fiode_tpu_torch package beside {__file__}")
    sys.path.insert(0, str(ROOT))
    from fiode_tpu_torch.entry import flagship
    from fiode_tpu_torch.models import ivp, layers
    from fiode_tpu_torch.models.dynamics import densify_dynamics_params
    from fiode_tpu_torch.ops._build import BUILD_DIR, load_library
    from fiode_tpu_torch.ops.cayley import apply_freq_matrices, cayley_conv_kernel
    from fiode_tpu_torch.ops.fused_cayley_conv import fused_freq_apply
    from fiode_tpu_torch.ops.fused_rhs import fused_rhs, pack_rhs_params, rhs_reference

    dev = torch.device("cuda", 0)

    # 1. device ---------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[1 device] {torch.cuda.get_device_name(0)} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn.allow_tf32="
        f"{torch.backends.cudnn.allow_tf32}")

    # 2. build ----------------------------------------------------------------
    t0 = time.perf_counter()
    for name in ("fused_rhs", "fused_cayley_conv"):
        load_library(name)
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for p in sorted(BUILD_DIR.glob("*.log"))
             for ln in p.read_text().splitlines()
             if "registers" in ln or "spill" in ln]
    log(f"[2 build] K1 + K3 built in {build_s:.1f} s into {BUILD_DIR}")
    for ln in ptxas:
        log(f"    ptxas: {ln}")

    model = flagship(N_CLASSES, MLP, generator=gen(SEED)).to(dev)
    errs = {"fused_rhs": 0.0, "fused_freq_apply": 0.0}

    # 3. K1 vs plain ----------------------------------------------------------
    with torch.no_grad():
        dense = densify_dynamics_params(model.dynamics)
        p = pack_rhs_params(dense["hidden_to_mlp"][0], dense["mlp_to_mlp"][0],
                            dense["mlp_to_hidden"][0], dense["mlp_to_mlp"][1],
                            dense["mlp_to_hidden"][1])
        h = torch.rand(K1_BATCH, N_CLASSES, generator=gen(1))
        h = (h / h.sum(-1, keepdim=True)).to(dev)
        xc = torch.randn(K1_BATCH, MLP, generator=gen(2)).to(dev)
        dyn = model.dynamics
        for sn in (False, True):
            args = (dyn.alpha_1, dyn.sigma_1, dyn.alpha_2, sn, dyn.qp_iters)
            got = fused_rhs(h, xc, p, *args)
            want = rhs_reference(h, xc, p, *args)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            errs["fused_rhs"] = max(errs["fused_rhs"], err)
            log(f"[3 K1] B={K1_BATCH} n={N_CLASSES} mlp={MLP} scale_nominal={sn}: "
                f"max|d|={err:.3e} (tol {K1_TOL:g})")
            if not err <= K1_TOL:
                raise RuntimeError(f"K1 disagrees with its plain version: {err}")

    # 4. K3 vs plain ----------------------------------------------------------
    q_by_shape = {}
    with torch.no_grad():
        for i, (ci, co, k, n) in enumerate(CONV_SHAPES):
            w = model.backbone.convs[i].weight
            if tuple(w.shape) != (co, ci, k, k):
                raise RuntimeError(f"conv {i} weight is {tuple(w.shape)}")
            Q = cayley_conv_kernel(w, model.backbone.convs[i].alpha, n)
            q_by_shape[i] = Q
            x = torch.randn(K3_BATCH, ci, n, n, generator=gen(10 + i)).to(dev)
            got = fused_freq_apply(x, Q.real.contiguous(), Q.imag.contiguous())
            want = apply_freq_matrices(x, Q, impl="dft")
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            errs["fused_freq_apply"] = max(errs["fused_freq_apply"], err)
            log(f"[4 K3] layer {i} ci={ci} co={co} n={n} B={K3_BATCH}: "
                f"max|d|={err:.3e} (tol {K3_TOL:g})")
            if not err <= K3_TOL:
                raise RuntimeError(f"K3 disagrees with its plain version: {err}")

    # 5. end to end -----------------------------------------------------------
    def plain_freq_apply(x, Qr, Qi):
        return apply_freq_matrices(x, torch.complex(Qr, Qi), impl="dft")

    @contextlib.contextmanager
    def plain_path():
        """Run the solve with both kernels replaced by their plain versions."""
        with mock.patch.object(ivp, "fused_rhs", rhs_reference), \
                mock.patch.object(layers, "fused_freq_apply", plain_freq_apply):
            yield

    def checked_solve(x):
        sol = model.solve(x)
        if sol.n_accepted + sol.n_rejected >= model.max_steps:
            raise RuntimeError(f"solve used its whole step budget ({model.max_steps})")
        return sol

    x = torch.rand(E2E_BATCH, 3, 32, 32, generator=gen(3)).to(dev)
    with torch.no_grad():
        fused_rhs.launches = 0
        fused_freq_apply.launches = 0
        sol_k = checked_solve(x)
        torch.cuda.synchronize()
        launches = {"fused_rhs": fused_rhs.launches,
                    "fused_freq_apply": fused_freq_apply.launches}
        with plain_path():
            sol_p = checked_solve(x)
        if fused_rhs.launches != launches["fused_rhs"] or \
                fused_freq_apply.launches != launches["fused_freq_apply"]:
            raise RuntimeError("the plain path launched a kernel")
    yk, yp = sol_k.ys[-1], sol_p.ys[-1]
    e2e_err = (yk - yp).abs().max().item()
    row_sum_err = (yk.sum(-1) - 1).abs().max().item()
    log(f"[5 e2e] B={E2E_BATCH}: kernel nfe={sol_k.nfe} acc={sol_k.n_accepted} "
        f"rej={sol_k.n_rejected} | plain nfe={sol_p.nfe} | max|d|={e2e_err:.3e} "
        f"(tol {E2E_TOL:g}) | max|sum h - 1|={row_sum_err:.2e} | launches {launches}")
    if tuple(yk.shape) != (E2E_BATCH, N_CLASSES) or not torch.isfinite(yk).all():
        raise RuntimeError(f"bad endpoint: shape {tuple(yk.shape)} or non-finite")
    if not e2e_err <= E2E_TOL:
        raise RuntimeError(f"kernel path disagrees with the plain path: {e2e_err}")
    if not row_sum_err <= E2E_TOL:
        raise RuntimeError(f"endpoint left the simplex: {row_sum_err}")
    if sol_k.nfe != sol_p.nfe:
        raise RuntimeError(f"NFE differs: kernel {sol_k.nfe} plain {sol_p.nfe}")
    if launches["fused_rhs"] != sol_k.nfe:
        raise RuntimeError(f"K1 launched {launches['fused_rhs']} times, NFE {sol_k.nfe}")
    if launches["fused_freq_apply"] != len(CONV_SHAPES):
        raise RuntimeError(f"K3 launched {launches['fused_freq_apply']} times, "
                           f"want {len(CONV_SHAPES)} per forward")

    # 6. timing ---------------------------------------------------------------
    xt = torch.rand(TIME_BATCH, 3, 32, 32, generator=gen(4)).to(dev)
    solve_ms = {"kernel": [], "plain": []}
    nfe = {}
    with torch.no_grad():
        checked_solve(xt[:256])  # warm-up of both paths
        with plain_path():
            checked_solve(xt[:256])
        for which in ("plain", "kernel", "kernel", "plain"):
            ctx = plain_path() if which == "plain" else contextlib.nullcontext()
            with ctx:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                sol = checked_solve(xt)
                torch.cuda.synchronize()
                solve_ms[which].append(1e3 * (time.perf_counter() - t0))
                nfe[which] = sol.nfe
    for which in ("kernel", "plain"):
        ms = min(solve_ms[which])
        log(f"[6 time] solve B={TIME_BATCH} {which}: {ms:.1f} ms/solve "
            f"(runs {[round(v, 1) for v in solve_ms[which]]}), nfe={nfe[which]}, "
            f"{TIME_BATCH * nfe[which] / (ms / 1e3):.4g} sample-NFE/s")

    with torch.no_grad():
        h = torch.rand(TIME_BATCH, N_CLASSES, generator=gen(5))
        h = (h / h.sum(-1, keepdim=True)).to(dev)
        xc = torch.randn(TIME_BATCH, MLP, generator=gen(6)).to(dev)
        args = (dyn.alpha_1, dyn.sigma_1, dyn.alpha_2, True, dyn.qp_iters)
        k1_plain = cuda_ms(lambda: rhs_reference(h, xc, p, *args), 20)
        k1_ms = cuda_ms(lambda: fused_rhs(h, xc, p, *args), 20)
        log(f"[6 time] K1 B={TIME_BATCH}: kernel {k1_ms:.4f} ms | plain {k1_plain:.4f} ms")
        k3_ms = k3_plain = 0.0
        for i, (ci, co, k, n) in enumerate(CONV_SHAPES):
            Q = q_by_shape[i]
            Qr, Qi = Q.real.contiguous(), Q.imag.contiguous()
            x = torch.randn(TIME_BATCH, ci, n, n, generator=gen(20 + i)).to(dev)
            t_plain = cuda_ms(lambda: apply_freq_matrices(x, Q, impl="dft"), 5)
            t_fft = cuda_ms(lambda: apply_freq_matrices(x, Q, impl="fft"), 5)
            t_kern = cuda_ms(lambda: fused_freq_apply(x, Qr, Qi), 5)
            k3_ms += t_kern
            k3_plain += t_plain
            log(f"[6 time] K3 layer {i} {ci}->{co} @{n} B={TIME_BATCH}: kernel "
                f"{t_kern:.3f} ms | plain dft {t_plain:.3f} ms | fft {t_fft:.3f} ms")
            del x

    kernels = [
        {"name": "fused_rhs", "route": "cuda",
         "source": "fiode_tpu_torch/csrc/fused_rhs.cu",
         "replaces": "fiode_tpu/ops/fused_rhs.py:140",
         "launches": launches["fused_rhs"], "max_abs_err": errs["fused_rhs"],
         "ms": k1_ms, "plain_ms": k1_plain},
        {"name": "fused_freq_apply", "route": "cuda",
         "source": "fiode_tpu_torch/csrc/fused_cayley_conv.cu",
         "replaces": "fiode_tpu/ops/fused_cayley_conv.py:61",
         "launches": launches["fused_freq_apply"],
         "max_abs_err": errs["fused_freq_apply"],
         "ms": k3_ms, "plain_ms": k3_plain},
    ]
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
