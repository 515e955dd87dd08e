"""maskbit_tpu_torch: the PyTorch / CUDA port of `maskbit_tpu` for NVIDIA H100.

Mirrors the JAX package's layout (`ops/`, `nn/`, `quantizers/`, `models/`,
`sampling/`, `cli/`, `compat/`, `core/`): the counterpart of
`maskbit_tpu/x/y.py` is `maskbit_tpu_torch/x/y.py`. The JAX package stays the
reference; this package imports `torch` and never `jax`.

Ported so far: class-conditional generation and its HTTP server (LFQBert,
the masked CFG sampler, the LFQ unpack and the conv decoder), with the
postnorm attention block as a hand-written CUDA kernel chain
(`csrc/attention_block.cu`); Stage-II training with the dropout-attention
kernels; evaluation (`eval/`: Inception, the ADM protocol, the streaming
evaluators; `cli/eval_maskbit`, `cli/eval_tokenizer`, `cli/make_stats`,
`cli/demo`); Stage-I tokenizer training (`train/tokenizer_trainer`,
`cli/train_tokenizer`: the LFQ and VQ training losses, the PatchGAN
discriminators, the GAN, perceptual and LPIPS losses).
"""

__version__ = "0.1.0"
