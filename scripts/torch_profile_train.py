#!/usr/bin/env python
"""Where the time of one train step goes on the PyTorch port, on one CUDA card.

    python scripts/torch_profile_train.py [--out PATH] [--steps N]
        [--compute_dtype float32|bfloat16] [--conv_precision highest|high|default]

The setting is chip_smoke.py's phase 11: ``mutopia_ccal_cont_rsz`` at full
width (24 filters, 32-D latent, sheet 160 x 200 halved, spectrogram
92 x 42), batch 100, a seeded init, one batch of the synthetic corpus with
the FULL augmentation of ``exp_configs/mutopia_full_aug.yaml``, under the
numerics given (float32 with TF32 off by default; bf16 convolutions with
``--compute_dtype bfloat16``, as phase 13 trains; each conv and both its
gradients as one TF32 pass with ``--conv_precision default``, as phase
13e trains). After a warm-up it
reports

- ``step``: the median CUDA-event time of one step (batch already on the
  card), for the polar whitening (the default) and for ``eigh``;
- ``profile``: ``--steps`` polar steps under ``torch.profiler`` (CPU +
  CUDA): ``wall_ms``, ``device_busy_ms`` (the union of the intervals of
  the kernels, copies and memsets), ``busy_share``, kernels launched a
  step, the longest kernels by name, and the kernel time a step by kind,
  from the kernels' names (``KINDS``): convolution forward and backward,
  max-pool, Adam, the products (the whitening's 32 x 32 Newton-Schulz
  products, the covariances, the score matrix), eigh, and the rest (BN
  statistics and affine, ELU, the loss: elementwise and reductions);
- ``whitening``: the CCA layer alone, forward and backward at the step's
  shape ([100, 32] latents a view): CUDA-event ms, kernels launched, and
  its share of the step;
- ``host_batch_ms``: the median host time to build one 100-sample batch
  from the pool (what the iterator's producer thread does each step);
- ``max_memory_allocated_mb`` over a step.

Each part prints one JSON line; the whole result goes to ``--out``
(default ``build/profile/profile_train_<dtype>_<precision>.json``).
Without a CUDA card the script exits non-zero.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from torch_profile_serving import device_summary  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# kernel name -> kind of device time, first match wins. cuDNN names its
# convolution kernels by algorithm (implicit GEMM "fprop", FFT with complex
# "cf32" GEMMs, Winograd; backward "dgrad" / "wgrad"), cuBLAS its products
# "gemm" / "gemv" (here the 32 x 32 whitening products, the covariances,
# the score matrix), cuSOLVER its eigensolvers "syev*"
KINDS = (("conv backward", ("dgrad", "wgrad", "bprop")),
         ("conv forward", ("fprop", "conv", "cudnn", "cf32", "fft",
                           "winograd", "flip_filter", "nchwkcrs")),
         ("max-pool", ("max_pool",)),
         ("adam", ("multi_tensor", "foreach", "adam")),
         ("products", ("gemm", "gemv", "dot_kernel", "splitkreduce")),
         ("eigh", ("syev", "cusolver", "stedc", "ormtr", "sytrd")))


def cuda_ms(fn, iters: int = 20, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def is_kernel(e) -> bool:
    """A device activity that is a kernel: not a copy or memset, not a user
    range mirrored on the device (``Optimizer.step#Adam.step``), not a
    runtime call."""
    return (e.device_type == torch.autograd.DeviceType.CUDA
            and not e.name.startswith(("Memcpy", "Memset", "cuda",
                                       "cuLaunch"))
            and "#" not in e.name)


def kernels_launched(prof) -> int:
    return sum(1 for e in prof.events() if is_kernel(e))


def busy_ms(prof) -> float:
    """The union of the kernels', copies' and memsets' intervals."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and "#" not in e.name)
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s_, e_ in spans[1:]:
        if s_ > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s_, e_
        else:
            cur_e = max(cur_e, e_)
    return (busy + cur_e - cur_s) / 1000.0


def by_kind(prof, n_steps: int) -> dict:
    """Kernel ms a step by kind (``KINDS``, from the kernel's name; the
    rest is elementwise passes and reductions: BN statistics and affine,
    ELU, the loss, the Newton-Schulz sums)."""
    out = collections.defaultdict(float)
    for e in prof.events():
        if not is_kernel(e):
            continue
        name = e.name.lower()
        kind = next((k for k, keys in KINDS
                     if any(key in name for key in keys)),
                    "elementwise and reductions")
        out[kind] += e.time_range.elapsed_us() / 1000.0 / n_steps
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--compute_dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--conv_precision", default="highest",
                    choices=["highest", "high", "default"])
    args = ap.parse_args(argv)
    out = args.out or os.path.join(
        REPO, "build", "profile", "profile_train_%s_%s.json"
        % (args.compute_dtype, args.conv_precision))
    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false; this profile "
                         "runs only on a CUDA card")

    from torch.profiler import ProfilerActivity, profile

    from audio_sheet_retrieval_tpu_torch import config
    from audio_sheet_retrieval_tpu_torch.data import synthetic
    from audio_sheet_retrieval_tpu_torch.models import cca_model
    from audio_sheet_retrieval_tpu_torch.models.configs import get_model_config
    from audio_sheet_retrieval_tpu_torch.ops import cca as cca_ops
    from audio_sheet_retrieval_tpu_torch.train import engine
    from audio_sheet_retrieval_tpu_torch.train import state as ts

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_model_config("mutopia_ccal_cont_rsz"),
                              compute_dtype=args.compute_dtype,
                              conv_precision=args.conv_precision)
    augment = config.load_experiment_config("mutopia_full_aug").augment
    pool = synthetic.load_synthetic_retrieval(
        n_train=6, n_valid=1, n_test=1, n_onsets=200,
        augment=augment)["train"]
    result = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
              "torch": torch.__version__, "cuda": torch.version.cuda,
              "batch": cfg.batch_size, "compute_dtype": cfg.compute_dtype,
              "conv_precision": cfg.conv_precision}

    def emit(part, **fields):
        result[part] = fields
        print(json.dumps({"part": part, **fields}), flush=True)

    host = []
    for i in range(10):
        t0 = time.perf_counter()
        x1, x2 = pool[i * cfg.batch_size:(i + 1) * cfg.batch_size]
        host.append((time.perf_counter() - t0) * 1000.0)
    emit("host_batch", host_batch_ms=float(np.median(host)),
         samples=cfg.batch_size)
    x1d, x2d = torch.from_numpy(x1).to(dev), torch.from_numpy(x2).to(dev)

    states = {}
    for w in ("polar", "eigh"):
        c = dataclasses.replace(cfg, whitening=w)
        state = ts.init_train_state(cca_model.init_model(
            torch.Generator().manual_seed(0), c, device=dev), c)
        step = engine.make_train_step(c)
        torch.cuda.reset_peak_memory_stats()
        states[w] = (state, step)
        emit("step_" + w, step_ms=cuda_ms(lambda: step(state, x1d, x2d)),
             max_memory_allocated_mb=torch.cuda.max_memory_allocated()
             / 2**20)

    state, step = states["polar"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step(state, x1d, x2d)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1000.0
    summary = device_summary(prof, wall_ms)
    busy = busy_ms(prof)
    emit("profile", steps=args.steps, wall_ms_per_step=wall_ms / args.steps,
         device_busy_ms_per_step=busy / args.steps,
         busy_share=busy / wall_ms,
         kernels_per_step=kernels_launched(prof) / args.steps,
         kernel_ms_per_step=sum(e.time_range.elapsed_us() for e in
                                prof.events() if is_kernel(e))
         / 1000.0 / args.steps,
         device_ms_per_step_by_kind=by_kind(prof, args.steps),
         top=summary["top"])

    # the CCA layer alone at the step's shape, forward and backward
    gen = torch.Generator(device=dev).manual_seed(1)
    H1 = torch.randn(cfg.batch_size, cfg.dim_latent, generator=gen,
                     device=dev, requires_grad=True)
    H2 = torch.randn(cfg.batch_size, cfg.dim_latent, generator=gen,
                     device=dev, requires_grad=True)
    zero = cca_ops.CCAState.zeros(cfg.dim_latent, device=dev)
    for w in ("polar", "eigh"):
        def layer():
            lv1, lv2, _, corr = cca_ops.cca_layer_train(
                H1, H2, zero, alpha=1.0, whitening=w)
            (lv1.sum() + lv2.sum() + corr.sum()).backward()

        ms = cuda_ms(layer)
        with profile(activities=[ProfilerActivity.CUDA]) as p2:
            layer()
            torch.cuda.synchronize()
        emit("whitening_" + w, ms=ms, kernels=kernels_launched(p2),
             share_of_step=ms / result["step_" + w]["step_ms"])

    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as fp:
        json.dump(result, fp, indent=1)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
