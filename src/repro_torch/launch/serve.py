"""Serving launcher: continuous batching on the BankedKVPool engine.

    PYTHONPATH=src python -m repro_torch.launch.serve                  # full width, CUDA
    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v2-lite-16b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-7b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch chameleon-34b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-3b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o-danube-1.8b --mix WINDOW
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b --mix FULL_SSD
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu

By default it serves stablelm-1.6b at full width on the CUDA card (random
weights from ``--seed``); ``--arch`` names another of the port's configs
(``repro_torch.configs.list_archs()``: olmoe-1b-7b, MoE with QK-norm;
deepseek-v2-lite-16b, MLA with one 576-wide latent row per token and layer
in the pool, decoded in the absorbed form, and MoE with shared experts, 32.4
GB of bf16 weights; deepseek-7b, dense MHA at 32 heads of 128, 13.8 GB;
chameleon-34b, dense GQA 64:8 at 128 with QK-norm, 68.6 GB, the largest that
fits the card beside its pool; stablelm-3b, dense MHA at 32 heads of 80, 5.6
GB; h2o-danube-1.8b, GQA 32:8 at 80 with a 4096-token sliding window, 3.67
GB; mamba2-1.3b, 48 SSM layers with tied embeddings, 2.7 GB).

``--mix`` picks the request mix (``MIXES``; default ``FULL``):
  FULL      16 requests with prompts of 128..1024 tokens, 32 new tokens
            each, 8 slots, 2048-token contexts, 16-token blocks;
  WINDOW    a mix that passes h2o-danube's 4096-token window: 8 requests,
            8 slots, 32 new tokens each, 4 prompts of exactly 8192 tokens
            (twice the window: the reference's rolling prefill takes only a
            whole number of windows) and 4 of 4065..4096 whose decode
            crosses position 4096; 8320-token contexts, 16-token blocks;
  FULL_SSD  FULL's seeded draws with every prompt longer than 256 tokens
            cut to a multiple of 256 (mamba2's chunk: the reference's
            ``ssd_chunked`` takes no other length);
  SMOKE     the reference launcher's sizes (8 requests of 4..15 prompt
            tokens, 8 new tokens, 4 slots, 64-token contexts, 8-token
            blocks), the default with ``--smoke`` (the reduced config).
A mix whose prompts the config cannot run as the reference runs them is
refused (``check_mix``).  ``--device cpu`` runs the plain PyTorch path on
the host.
"""

from __future__ import annotations

import argparse
import json
import time
from dataclasses import asdict, dataclass, replace
from typing import Tuple

import numpy as np

from repro_torch.configs import ModelConfig, get_config, smoke
from repro_torch.kernels import LAUNCHES
from repro_torch.models import model as M
from repro_torch.serving.engine import ServingEngine


@dataclass(frozen=True)
class ServeSpec:
    """One serving run: the request mix and the engine's sizes."""

    requests: int = 16
    prompt_lo: int = 128  # prompt lengths drawn from [prompt_lo, prompt_hi)
    prompt_hi: int = 1025
    max_new_tokens: int = 32
    max_batch: int = 8
    max_len: int = 2048
    block_size: int = 16
    #: per request, its own [lo, hi) in place of (prompt_lo, prompt_hi)
    prompt_ranges: Tuple[Tuple[int, int], ...] = ()
    #: > 0: a prompt longer than this is cut to a multiple of it
    chunk: int = 0


FULL = ServeSpec()
SMOKE = ServeSpec(
    requests=8, prompt_lo=4, prompt_hi=16, max_new_tokens=8, max_batch=4, max_len=64, block_size=8
)
WINDOW = ServeSpec(
    requests=8,
    max_len=8320,
    prompt_ranges=((8192, 8193),) * 4 + ((4065, 4097),) * 4,
)
FULL_SSD = replace(FULL, chunk=256)
MIXES = {"FULL": FULL, "WINDOW": WINDOW, "FULL_SSD": FULL_SSD, "SMOKE": SMOKE}


def make_prompts(cfg: ModelConfig, spec: ServeSpec, seed: int = 0):
    """Seeded prompts, drawn as the reference launcher draws them (a length,
    then the tokens, per request); ``spec.chunk`` cuts a drawn prompt to a
    whole number of chunks, so the draws stay those of the mix without it."""
    rng = np.random.default_rng(seed)
    ranges = spec.prompt_ranges or ((spec.prompt_lo, spec.prompt_hi),) * spec.requests
    prompts = []
    for lo, hi in ranges:
        p = rng.integers(0, cfg.vocab_size, int(rng.integers(lo, hi)))
        if spec.chunk and len(p) > spec.chunk:
            p = p[: len(p) // spec.chunk * spec.chunk]
        prompts.append(p)
    return prompts


def check_mix(cfg: ModelConfig, spec: ServeSpec, prompts) -> None:
    """Refuse prompts the reference's model cannot run with ``cfg``
    (``ValueError``): an SSM stack's prompt longer than its chunk must be a
    whole number of chunks (``ssd_chunked``'s assert), and where contexts
    outgrow a sliding window, a prompt longer than the window a whole
    number of windows (the rolling prefill's assert)."""
    for n in map(len, prompts):
        chunk = min(cfg.ssm_chunk, n)
        if cfg.family == "ssm" and n % chunk:
            raise ValueError(
                f"{cfg.name}: a prompt of {n} tokens is no whole number of {cfg.ssm_chunk}-token "
                "chunks, which the reference's ssd_chunked refuses; serve the FULL_SSD mix"
            )
        w = cfg.sliding_window
        if w and spec.max_len > w and n > w and n % w:
            raise ValueError(
                f"{cfg.name}: a prompt of {n} tokens past the {w}-token window is no whole "
                "number of windows, which the reference's rolling prefill refuses"
            )


def new_engine(cfg, model, spec: ServeSpec, prompts, engine_cls=ServingEngine, recorder=None):
    """An engine of ``spec``'s sizes with ``prompts`` submitted; ``recorder``
    (a ``serving.record.KVAccessRecorder``) records its KV access stream."""
    eng = engine_cls(
        cfg,
        model,
        max_batch=spec.max_batch,
        max_len=spec.max_len,
        block_size=spec.block_size,
        recorder=recorder,
    )
    reqs = [eng.submit(p, max_new_tokens=spec.max_new_tokens) for p in prompts]
    return eng, reqs


def serve(eng: ServingEngine, reqs, max_steps: int = 1000) -> dict:
    """Run ``eng`` until every request is done; returns the run's summary."""
    t0 = time.perf_counter()
    eng.run(max_steps)
    return summarize(eng, reqs, time.perf_counter() - t0)


def summarize(eng: ServingEngine, reqs, wall: float) -> dict:
    """The run's counts and rates over ``wall`` host seconds (which include
    the device's work: each prefill and decode step reads its tokens)."""
    st = eng.stats
    out_tokens = sum(len(r.out_tokens) for r in reqs)
    return {
        "requests": len(reqs),
        "done": sum(r.done for r in reqs),
        "out_tokens": out_tokens,
        "steps": eng.steps,
        "wall_s": wall,
        "out_tokens_per_s": out_tokens / wall,
        "prefill_tokens_per_s": st.prefill_tokens / st.prefill_s if st.prefill_s else None,
        "decode_ms_per_step": 1e3 * st.decode_s / st.decode_steps if st.decode_steps else None,
        "pool_imbalance": eng.pool.imbalance(),
        "stats": asdict(st),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument(
        "--arch",
        default="stablelm-1.6b",
        help="one of repro_torch.configs.list_archs(): stablelm-1.6b, olmoe-1b-7b, "
        "deepseek-v2-lite-16b, deepseek-7b, chameleon-34b, stablelm-3b, h2o-danube-1.8b "
        "or mamba2-1.3b",
    )
    ap.add_argument("--smoke", action="store_true", help="reduced config and sizes")
    ap.add_argument(
        "--mix", choices=sorted(MIXES), help="the request mix (default: FULL, SMOKE with --smoke)"
    )
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int)
    ap.add_argument("--max-batch", type=int)
    ap.add_argument("--max-new-tokens", type=int)
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    spec = MIXES[args.mix or ("SMOKE" if args.smoke else "FULL")]
    if args.smoke:
        cfg = smoke(cfg)
    for name in ("requests", "max_batch", "max_new_tokens"):
        if getattr(args, name) is not None:
            spec = replace(spec, **{name: getattr(args, name)})
    if args.requests is not None and spec.prompt_ranges:
        spec = replace(spec, prompt_ranges=spec.prompt_ranges[: args.requests])
    prompts = make_prompts(cfg, spec, args.seed)
    check_mix(cfg, spec, prompts)
    model = M.init_params(cfg, args.seed, device=args.device)
    eng, reqs = new_engine(cfg, model, spec, prompts)
    summary = serve(eng, reqs)
    summary["launches"] = dict(LAUNCHES)
    summary["device"] = str(model.device)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
