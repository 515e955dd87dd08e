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
discriminators, the GAN, perceptual and LPIPS losses); the Bert generator
and the taming VQGAN baselines; `cli/convert_checkpoint` between the
original repo's `.bin` and the zoo's `.msgpack`; the data, fsdp and tensor
axes across processes (`parallel/`); one batch split over a process's
cards (`sampling/serve.py`); the native JPEG decoder (`native/`). Every
module of the JAX package has its counterpart except `gelu_erf`, whose
polynomial only served XLA on the TPU: the port uses exact-erf GELU.
"""

__version__ = "0.1.0"
