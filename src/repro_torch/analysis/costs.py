"""Analytic FLOPs and bytes per (arch x shape) cell: the port's copy of the
reference's ``analysis/costs.py``, with an H100's rates in place of the
TPU's.

The counts are the reference's, rule for rule, for every stack the port runs
(uniform GQA or MLA attention on every layer, dense or MoE, uniform SSM
stacks, hybrid stacks, layer by layer through ``is_attn_layer`` and
``is_moe_layer``, and encoder-decoder stacks):
  * a matrix product [.., m, k] x [k, n] is 2 m k n FLOPs; elementwise work
    is not counted (under 1 %);
  * attention's scores and P V count the rectangle they visit: S T, or
    S (S + 1) / 2 for causal self-attention with ``triangular=True`` (the
    kernels skip fully masked tiles always, so on the card that is the
    count that runs);
  * MLA's non-absorbed form counts the up-projection of every cached row
    and scores at QK width ``qk_nope + qk_rope``, P V at ``v_head_dim``; the
    absorbed decode counts the latent-space products instead;
  * MoE counts the capacity buffer computed, E C slots per sequence
    (``models.moe.expert_capacity``), padding included;
  * an SSM layer counts its projections, conv taps and SSD: per chunk the
    C B^T and M x products, the chunk states and the inter-chunk readout
    (prefill, training), or the state update and readout (decode); its
    cache holds the float32 state and a conv window per sequence, whatever
    the context (a sliding window does not shorten the reference's count:
    it counts ``cache_len`` rows);
  * an encoder-decoder stack (whisper) adds, outside decode, its encoder
    layers' attention over ``encoder_seq_len`` frames (non-causal: the full
    rectangle) and FFN, and in every decoder layer, decode included, the
    cross-attention: the q projection of the decoder's tokens (the
    reference counts no output projection there), the K and V projections
    of every frame, scores and P V over the frames;
  * a training step is 3 forwards (4 with ``remat="full"``).

``model_flops`` is the 6 N D yardstick (2 N D for inference) over the
parameters a token touches (``active_params``: the top-k of the routed
experts).  ``roofline_terms`` divides the counts by the card's rates below;
``chips`` and ``tp`` keep the reference's meaning (devices in all, tensor-
parallel width), so a count per device equals the reference's.
"""

from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ModelConfig, ShapeConfig, check_supported
from repro_torch.models.moe import expert_capacity

#: H100 SXM dense bf16 tensor-core rate, FLOP/s (NVIDIA H100 data sheet)
PEAK_FLOPS = 989e12
#: H100 SXM HBM3 rate, bytes/s (NVIDIA H100 data sheet)
HBM_BW = 3.35e12
#: NVLink 4 between the cards of one host, bytes/s each way (900 GB/s both
#: ways; NVIDIA H100 data sheet)
NVLINK_BW = 450e9


def _attn_flops(cfg: ModelConfig, B, S, T, *, triangular=False) -> float:
    d, h, g, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    proj = 2 * B * S * d * (h * hd + 2 * g * hd) + 2 * B * S * h * hd * d
    st = S * (S + 1) / 2 if (triangular and S == T) else S * T
    return proj + 2 * 2 * B * h * hd * st


def _mla_flops(cfg: ModelConfig, B, S, T, *, decode_absorbed=False, triangular=False) -> float:
    d, h = cfg.d_model, cfg.num_heads
    r, dn, dr, dv = cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    f = 2 * B * S * d * (h * (dn + dr))  # q projection
    f += 2 * B * S * d * (r + dr)  # latent c_kv and k_pe
    f += 2 * B * S * h * dv * d  # output projection
    st = S * (S + 1) / 2 if (triangular and S == T) else S * T
    if decode_absorbed:
        f += 2 * B * S * h * dn * r  # q absorbed into latent space
        f += 2 * 2 * B * h * st * (r + dr)  # latent scores and P V
        f += 2 * B * S * h * r * dv  # output absorption
    else:
        f += 2 * B * T * r * h * (dn + dv)  # up-projection of every row
        f += 2 * 2 * B * h * st * (dn + dr + dv) / 2 * 2  # scores and P V, as the reference
    return f


def _ssm_flops(cfg: ModelConfig, B, S, *, decode=False) -> float:
    d, di = cfg.d_model, cfg.d_inner
    g, n, h, ph = cfg.ssm_num_groups, cfg.ssm_state_dim, cfg.ssm_num_heads, cfg.ssm_head_dim
    f = 2 * B * S * d * (2 * di + 2 * g * n + h)  # z, x, B, C, dt projections
    f += 2 * B * S * di * d  # output projection
    f += 2 * B * S * (di + 2 * g * n) * cfg.ssm_conv_width
    if decode:
        f += 2 * B * S * h * ph * n * 2  # state update and readout
    else:
        chunk = min(cfg.ssm_chunk, S)
        f += 2 * B * S * chunk * g * n  # G = C B^T per chunk
        f += 2 * B * S * chunk * h * ph  # M x
        f += 2 * 2 * B * S * h * ph * n  # chunk states and y_inter
    return f


def _moe_flops(cfg: ModelConfig, B, S) -> float:
    d = cfg.d_model
    fe = cfg.moe_d_ff or cfg.d_ff
    C = expert_capacity(cfg, S)
    f = 2 * B * S * d * cfg.moe_num_experts  # router
    f += 3 * 2 * B * cfg.moe_num_experts * C * d * fe  # the capacity buffer
    if cfg.moe_num_shared:
        f += 3 * 2 * B * S * d * (cfg.moe_num_shared * fe)
    return f


def _ffn_flops(cfg: ModelConfig, B, S) -> float:
    mult = 3 if cfg.mlp_type == "swiglu" else 2
    return mult * 2 * B * S * cfg.d_model * cfg.d_ff


def forward_flops(
    cfg: ModelConfig,
    B: int,
    S: int,
    *,
    kind: str,
    cache_len: int = 0,
    triangular: bool = False,
    mla_absorbed: bool = False,
) -> float:
    """Forward FLOPs of one step over all devices."""
    check_supported(cfg)
    decode = kind == "decode"
    T = cache_len if decode else S
    total = 0.0
    for li in range(cfg.num_layers):
        if not cfg.is_attn_layer(li):
            total += _ssm_flops(cfg, B, S, decode=decode)
        elif cfg.use_mla:
            total += _mla_flops(
                cfg, B, S, T, triangular=triangular, decode_absorbed=mla_absorbed and decode
            )
        else:
            total += _attn_flops(cfg, B, S, T, triangular=triangular)
        if cfg.is_moe_layer(li):
            total += _moe_flops(cfg, B, S)
        elif cfg.d_ff:
            total += _ffn_flops(cfg, B, S)
    if cfg.is_encoder_decoder:
        Te = cfg.encoder_seq_len
        if not decode:
            total += cfg.num_encoder_layers * (_attn_flops(cfg, B, Te, Te) + _ffn_flops(cfg, B, Te))
        d, h, g, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        total += cfg.num_layers * (
            2 * 2 * B * h * hd * S * Te + 2 * B * S * d * h * hd + 2 * B * Te * d * 2 * g * hd
        )
    logit_rows = B * S if kind == "train" else B
    return total + 2 * logit_rows * cfg.d_model * cfg.padded_vocab


def step_flops(
    cfg: ModelConfig,
    shape: ShapeConfig,
    *,
    cache_len: int = 0,
    remat: str = "full",
    triangular: bool = False,
    mla_absorbed: bool = False,
) -> float:
    f = forward_flops(
        cfg,
        shape.global_batch,
        1 if shape.kind == "decode" else shape.seq_len,
        kind=shape.kind,
        cache_len=cache_len or shape.seq_len,
        triangular=triangular,
        mla_absorbed=mla_absorbed,
    )
    if shape.kind == "train":
        return f * (4.0 if remat == "full" else 3.0)
    return f


def active_params(cfg: ModelConfig) -> int:
    """Parameters a token touches: the routed experts scaled by top-k / E."""
    n = cfg.num_params()
    if cfg.moe_num_experts:
        fe = cfg.moe_d_ff or cfg.d_ff
        moe_layers = sum(cfg.is_moe_layer(i) for i in range(cfg.num_layers))
        routed = moe_layers * cfg.moe_num_experts * 3 * cfg.d_model * fe
        active = moe_layers * cfg.moe_top_k * 3 * cfg.d_model * fe
        n = n - routed + active
    return n


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """The 6 N D yardstick (2 N D for an inference forward), N active."""
    tokens = shape.global_batch * (1 if shape.kind == "decode" else shape.seq_len)
    return (6 if shape.kind == "train" else 2) * active_params(cfg) * tokens


def hbm_bytes_per_device(
    cfg: ModelConfig,
    shape: ShapeConfig,
    *,
    chips: int,
    tp: int = 16,
    cache_len: int = 0,
    remat: str = "full",
) -> float:
    """Device-memory traffic per device and step, the dominant terms only
    (the reference's formula)."""
    P = cfg.num_params()
    tokens_local = (
        shape.global_batch * (1 if shape.kind == "decode" else shape.seq_len) / max(chips // tp, 1)
    )
    d = cfg.d_model
    if shape.kind == "train":
        # float32 parameters read, gradients written, the optimizer's state
        # (AdamW's moments read and written, 16 B; Adafactor's factors, which
        # the reference counts as 2 B for jamba, its Adafactor arch), bf16
        # copies of the weights (4 B)
        opt_bytes = 2 if "jamba" in cfg.name else 16
        param_io = P / chips * (4 + 4 + opt_bytes + 4)
        act_io = tokens_local * d * 2 * 2 * (2 + 1) * cfg.num_layers / tp * 4
        return param_io + act_io
    if shape.kind == "prefill":
        param_io = P * 2 / tp  # bf16 weights read once
        act_io = tokens_local * d * 2 * 6 * cfg.num_layers / tp
        return param_io + act_io
    # decode: the weights and the device's whole KV cache per token
    param_io = P * 2 / (chips if shape.global_batch == 1 else tp)
    return param_io + cache_bytes_per_device(cfg, shape, chips=chips, tp=tp, cache_len=cache_len)


def cache_bytes_per_device(
    cfg: ModelConfig, shape: ShapeConfig, *, chips: int, tp: int = 16, cache_len: int = 0
) -> float:
    """bf16 KV cache bytes per device: K and V per layer, or MLA's latent
    row; an SSM layer's float32 state and bf16 conv window per sequence
    (the reference counts three conv rows)."""
    check_supported(cfg)
    T = cache_len or shape.seq_len
    dp = max(chips // tp, 1)
    n_attn = cfg.num_attn_layers
    per_tok = n_attn * (
        cfg.latent_dim * 2 if cfg.use_mla else 2 * cfg.num_kv_heads * cfg.resolved_head_dim * 2
    )
    per_seq = 0
    if cfg.ssm_state_dim:
        state = cfg.ssm_num_heads * cfg.ssm_head_dim * cfg.ssm_state_dim * 4
        per_seq = (cfg.num_layers - n_attn) * (state + cfg.ssm_conv_dim * 3 * 2)
    total = shape.global_batch * (T * per_tok + per_seq)
    return total / min(chips, dp * tp)


def roofline_terms(
    cfg: ModelConfig,
    shape: ShapeConfig,
    *,
    chips: int,
    tp: int = 16,
    cache_len: int = 0,
    wire_bytes: float = 0.0,
    remat: str = "full",
    triangular: bool = False,
    mla_absorbed: bool = False,
) -> Dict[str, float]:
    """The step's counts per device and its least times at the card's rates:
    compute, device memory, NVLink (``wire_bytes`` each way)."""
    f_total = step_flops(
        cfg,
        shape,
        cache_len=cache_len,
        remat=remat,
        triangular=triangular,
        mla_absorbed=mla_absorbed,
    )
    f_dev = f_total / chips
    b_dev = hbm_bytes_per_device(cfg, shape, chips=chips, tp=tp, cache_len=cache_len, remat=remat)
    t_c = f_dev / PEAK_FLOPS
    t_m = b_dev / HBM_BW
    t_n = wire_bytes / NVLINK_BW
    dom = max((t_c, "compute"), (t_m, "memory"), (t_n, "collective"))
    mf = model_flops(cfg, shape)
    bound = max(t_c, t_m, t_n)
    return {
        "flops_per_device": f_dev,
        "hbm_bytes_per_device": b_dev,
        "wire_bytes_per_device": wire_bytes,
        "compute_s": t_c,
        "memory_s": t_m,
        "collective_s": t_n,
        "bottleneck": dom[1],
        "model_flops": mf,
        "useful_ratio": mf / max(f_total, 1.0),
        "step_s_bound": bound,
        "roofline_fraction": t_c / bound if bound else 0.0,
        # the share of the 6 N D throughput at the card's peak that the bound allows
        "mfu_bound": (mf / chips / PEAK_FLOPS) / max(bound, 1e-30),
    }
