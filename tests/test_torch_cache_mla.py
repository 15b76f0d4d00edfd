"""MLA's contiguous cache (``smoke(deepseek-v2-lite-16b)``) against the
reference's, in both decode forms: the absorbed form on the latent call
(the cache's one row of ``kv_lora_rank + qk_rope_dim`` read as K, its first
``kv_lora_rank`` columns as V) and the non-absorbed form (the rows
up-projected, plain PyTorch); per-row positions; the cache form against
the pool form.  Also the paged call's log-sum-exp output (what the sharded
decode merges ranks by) against a direct one, and the view's block size
at ``decode_32k``'s length (the latent call stages at most
``LATENT_MAX_TABLE`` blocks a sequence).  XLA's CPU backend cannot run the
reference's bf16 absorbed form, so in bf16 both port forms are held to its
non-absorbed one (``test_torch_model_mla.py``).  Tolerances as
``test_torch_cache.py``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.kernels.paged_attention.ops import (  # noqa: E402
    LATENT_MAX_TABLE,
    MAX_SPLITS,
    blocks_per_split,
)
from repro_torch.kernels.paged_attention.ref import paged_attention_ref  # noqa: E402
from repro_torch.models.attention import CacheView, view_block_size  # noqa: E402
from test_torch_cache import POOL_TOL, check_pair, pool_logits, run_pair  # noqa: E402

ARCH = "deepseek-v2-lite-16b"


@pytest.mark.parametrize("absorbed", [False, True], ids=["paper", "absorbed"])
def test_mla_cache_matches_reference(absorbed):
    check_pair(run_pair(ARCH, absorbed=absorbed, S=8, pos0=[8, 6], steps=4))


@pytest.mark.parametrize("absorbed", [False, True], ids=["paper", "absorbed"])
def test_mla_cache_bf16(absorbed):
    res = run_pair(ARCH, dtype="bfloat16", absorbed=absorbed, ref_absorbed=False)
    check_pair(res, "bfloat16")


@pytest.mark.parametrize("absorbed", [False, True], ids=["paper", "absorbed"])
def test_mla_cache_matches_pool_form(absorbed):
    out, _, _, model, toks, inputs = run_pair(ARCH, absorbed=absorbed, S=9)
    pool = pool_logits(model, toks, inputs, absorbed=absorbed)
    for i, (got, want) in enumerate(zip([o[0] for o in out], pool)):
        np.testing.assert_allclose(got, want, rtol=0, atol=POOL_TOL, err_msg=f"call {i}")


def test_view_block_sizes():
    """The views the cells' caches take fit the kernel's limits: decode_32k
    at 2048 blocks of 16 a sequence, jamba's long_500k at 32768, within
    ``MAX_SPLITS`` splits; the latent call within ``LATENT_MAX_TABLE``
    blocks; rows a whole number of 16-byte pieces (G x D and the latent row
    in bf16) for every config."""
    assert view_block_size(32768) == 16 and view_block_size(32768, latent=True) == 32
    assert 32768 // view_block_size(32768, latent=True) == LATENT_MAX_TABLE
    assert view_block_size(4096, latent=True) == 16 and view_block_size(1500) == 4
    assert view_block_size(13) == 1
    for T in (32768, 524288):
        bs = view_block_size(T)
        assert -(-(T // bs) // blocks_per_split(bs)) <= MAX_SPLITS, T
    for arch in list_archs():
        cfg = get_config(arch)
        width = cfg.latent_dim if cfg.use_mla else cfg.num_kv_heads * cfg.resolved_head_dim
        assert width * 2 % 16 == 0, arch
    view = CacheView.make(torch.tensor([0, 40, 100]), 64)
    assert view.block_table.tolist()[1] == [4, 5, 6, 7] and view.lengths.tolist() == [1, 41, 64]


@pytest.mark.parametrize("shape", [(4, 8, 2, 32, 32), (3, 16, 1, 576, 512)], ids=["gqa", "latent"])
def test_paged_lse_matches_direct(shape):
    """``return_lse``: each head's log-sum-exp of its scaled scores over the
    valid tokens (-inf for a request with none), and the output unchanged."""
    B, H, G, D, Dv = shape
    g = torch.Generator().manual_seed(0)
    bs, mb = 4, 6
    k = torch.randn(B * mb, bs, G, D, generator=g)
    v = k[..., :Dv] if Dv != D else torch.randn(B * mb, bs, G, D, generator=g)
    q = torch.randn(B, H, D, generator=g)
    table = torch.arange(B * mb, dtype=torch.int32).view(B, mb)
    lengths = torch.tensor([0, 7, 24, 13][:B], dtype=torch.int32)
    out, lse = paged_attention_ref(q, k, v, table, lengths, scale=0.1, return_lse=True)
    torch.testing.assert_close(out, paged_attention_ref(q, k, v, table, lengths, scale=0.1))
    rows = k.view(B, mb * bs, G, D)
    for b in range(B):
        n = int(lengths[b])
        s = torch.einsum("gmd,tgd->gmt", q[b].view(G, H // G, D), rows[b, :n]) * 0.1
        want = torch.logsumexp(s, -1).reshape(H) if n else torch.full((H,), -torch.inf)
        torch.testing.assert_close(lse[b], want)
