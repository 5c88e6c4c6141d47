"""PyTorch port: `TransformerLM` held to the JAX package's model.

The JAX model's parameters (made from its seed) are carried across with
`TransformerLM.from_jax_params`; the same seeded numpy tokens go through
`TransformerLM.apply` (per sequence) and the port's batched forward on the
CPU, where attention takes the kernel's plain version. The slice as a whole
is held the same way: both packages score the tokens through `map_blocks`
with a plain function.

Tolerance: rtol 1e-4, atol 1e-5. Both sides are float32 with the same
arithmetic, but matrix products and layer-norm sums round in different
orders in the two frameworks, across two layers.
"""

import jax
import numpy as np
import pytest
import torch

import tensorframes_tpu as tfs
import tensorframes_tpu_torch as tft
from tensorframes_tpu.models.transformer import TransformerLM as JaxLM
from tensorframes_tpu_torch.models import TransformerLM
from tensorframes_tpu_torch.ops.flash_attention import flash_attention_reference

_RTOL, _ATOL = 1e-4, 1e-5
_CFG = dict(vocab=32, d_model=16, n_heads=2, n_layers=2, max_seq=24, seed=0)


@pytest.fixture(scope="module")
def models():
    jm = JaxLM(**_CFG)
    params = {k: np.asarray(v) for k, v in jm.params.items()}
    tm = TransformerLM.from_jax_params(params, n_heads=_CFG["n_heads"], device="cpu")
    return jm, tm


def _tokens(b, s, seed=0):
    return np.random.default_rng(seed).integers(0, _CFG["vocab"], (b, s)).astype(np.int32)


def _jax_logits(jm, tokens):
    return np.stack([np.asarray(jm.apply(jm.params, t)) for t in tokens])


class TestForward:
    @pytest.mark.parametrize("b,s", [(1, 24), (3, 11)])
    def test_matches_jax_apply(self, models, b, s):
        jm, tm = models
        tokens = _tokens(b, s)
        out = tm(torch.from_numpy(tokens))
        assert out.shape == (b, s, _CFG["vocab"]) and out.dtype == torch.float32
        np.testing.assert_allclose(
            out.numpy(), _jax_logits(jm, tokens), rtol=_RTOL, atol=_ATOL
        )

    def test_attention_is_pluggable(self, models):
        """The CPU wrapper and the plain version give the same logits
        (chip_smoke.py scores with the CUDA kernel against the plain version
        the same way)."""
        _, tm = models
        tokens = torch.from_numpy(_tokens(2, 9, seed=1))
        torch.testing.assert_close(
            tm(tokens), tm(tokens, attention=flash_attention_reference), rtol=0, atol=0
        )

    def test_params_carried_across(self, models):
        jm, tm = models
        assert set(tm.params) == set(jm.params)
        for k, v in jm.params.items():
            np.testing.assert_array_equal(tm.params[k].numpy(), np.asarray(v))

    def test_bad_params_refused(self, models):
        jm, _ = models
        params = {k: np.asarray(v) for k, v in jm.params.items()}
        params["l0_proj"] = params["l0_proj"][:, :-1]
        with pytest.raises(ValueError, match="l0_proj"):
            TransformerLM.from_jax_params(params, n_heads=2, device="cpu")
        with pytest.raises(ValueError, match="divide"):
            TransformerLM(vocab=8, d_model=10, n_heads=3, device="cpu")


class TestScoringThroughMapBlocks:
    def test_frame_function_front_end_matches_reference(self, models):
        jm, tm = models
        data = {"tokens": _tokens(6, 12, seed=2)}
        jdf = tfs.TensorFrame.from_dict(data, num_blocks=3)
        tdf = tft.TensorFrame.from_dict(data, num_blocks=3)

        def jax_score(tokens):
            return {"logits": jax.vmap(lambda t: jm.apply(jm.params, t))(tokens)}

        def port_score(tokens):
            return {"logits": tm(tokens)}

        ref = tfs.map_blocks(jax_score, jdf)
        out = tft.map_blocks(port_score, tdf, device="cpu")
        assert out.columns == ref.columns == ["logits", "tokens"]
        assert out.offsets == [int(o) for o in ref.offsets]
        np.testing.assert_allclose(
            out.host_values("logits"), ref.host_values("logits"), rtol=_RTOL, atol=_ATOL
        )
