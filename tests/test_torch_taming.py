"""Port parity: the taming VQGAN (`models/taming.OriginalVQModel`) against
`maskbit_tpu.models.taming.OriginalVQModel` with the same weights.

The small config of `tests/test_parity_taming.py` (32 px, `ch_mult` (1, 2),
so the second level runs at 16 px and has attention, beside the mid
block's). The JAX parameters go through the port's exporter
(`compat/torch_export.export_tokenizer_state`, CompVis's key names) into the
port's module, strictly. Float32 on both sides: tokens (the VQ argmin)
exactly equal; reconstructions and decoded tokens within atol 1e-4 (the
same float32 convolutions and GroupNorms in other summation orders).
A CompVis-layout `.bin` with the `loss.*` keys a taming checkpoint bundles
loads strictly through `core.checkpoint.load_pretrained`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from maskbit_tpu.models.taming import OriginalVQModel as JaxOriginalVQModel
from maskbit_tpu_torch.compat.torch_export import export_tokenizer_state
from maskbit_tpu_torch.compat.weights import tokenizer_from_flax
from maskbit_tpu_torch.core.checkpoint import load_pretrained
from maskbit_tpu_torch.models.taming import OriginalVQModel

torch.set_num_threads(2)

SMALL = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(16,), resolution=32,
             z_channels=64, codebook_size=32, token_size=48)


def _pair():
    jmodel = JaxOriginalVQModel(**SMALL)
    variables = jax.tree.map(np.asarray, jax.jit(jmodel.init)(jax.random.key(0),
                                                               jnp.zeros((1, 32, 32, 3))))
    # flax's init leaves biases at 0 and GroupNorm at (1, 0): perturb every
    # parameter so that a misplaced bias or norm shows
    rng = np.random.default_rng(1)
    variables = jax.tree.map(
        lambda v: (v + rng.normal(scale=0.05, size=v.shape)).astype(np.float32), variables)
    return jmodel, variables, tokenizer_from_flax(variables, OriginalVQModel(**SMALL).eval())


def test_taming_matches_jax():
    jmodel, variables, tmodel = _pair()
    x = np.random.default_rng(2).uniform(size=(2, 32, 32, 3)).astype(np.float32)
    apply = jax.jit(jmodel.apply, static_argnames="method")
    jrecon, jresult = apply(variables, jnp.asarray(x))
    jtokens = np.asarray(jresult["min_encoding_indices"])  # what `tokenize` returns
    with torch.inference_mode():
        recon, result = tmodel(torch.from_numpy(x))
        z_quantized, _ = tmodel.encode(torch.from_numpy(x))
        tokens = tmodel.tokenize(torch.from_numpy(x))
        flat = tokens.reshape(2, -1)
        decoded = tmodel.decode_tokens(flat)
    jz, _ = apply(variables, jnp.asarray(x), method="encode")
    jdecoded = apply(variables, jnp.asarray(jtokens.reshape(2, -1)), method="decode_tokens")
    assert tokens.shape == (2, 16, 16) and len(np.unique(jtokens)) > 4
    np.testing.assert_array_equal(tokens.numpy(), jtokens)
    np.testing.assert_array_equal(result["min_encoding_indices"].numpy(), jtokens)
    np.testing.assert_allclose(z_quantized.numpy(), np.asarray(jz), atol=1e-4, rtol=0)
    np.testing.assert_allclose(recon.numpy(), np.asarray(jrecon), atol=1e-4, rtol=0)
    np.testing.assert_allclose(decoded.numpy(), np.asarray(jdecoded), atol=1e-4, rtol=0)
    for key in ("quantizer_loss", "commitment_loss", "codebook_loss"):
        np.testing.assert_allclose(float(result[key]), float(jresult[key]), rtol=1e-5)


def test_taming_bin_with_loss_keys_loads(tmp_path):
    _, variables, tmodel = _pair()
    state = export_tokenizer_state(variables)
    # CompVis's names: the mid block's children keep their underscores
    assert "encoder.mid.block_1.norm1.weight" in state
    assert "decoder.up.1.attn.0.proj_out.weight" in state and "quantize.embedding.weight" in state
    assert state.keys() == tmodel.state_dict().keys()
    full = {k: torch.from_numpy(np.array(v)) for k, v in state.items()}
    full["loss.discriminator.main.0.weight"] = torch.zeros(4, 4)
    full["loss.logvar"] = torch.zeros(())
    path = str(tmp_path / "last.ckpt.bin")
    torch.save({"state_dict": full}, path)
    model = OriginalVQModel(**SMALL).eval()
    model.load_state_dict(load_pretrained(path), strict=True)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, full[k], atol=0, rtol=0)
