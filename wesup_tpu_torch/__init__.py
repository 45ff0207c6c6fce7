"""WESUP on PyTorch and CUDA: the port of ``wesup_tpu`` to an NVIDIA H100.

The package mirrors ``wesup_tpu``'s module names so that each module's
counterpart is easy to find, and imports neither jax nor ``wesup_tpu``.
Plain tensor work (convolutions, matmuls, SLIC, augmentation) is PyTorch;
the kernels that the JAX package wrote in Pallas (the superpixel pooling
kernels and their backward bodies, the general segment sum, the adjoint
stage pool and the fused stage-1 pool) are CUDA kernels (``csrc/*.cu``),
built with ``nvcc`` on first use.

Entry points (``inference.Predictor`` and ``predict_*``,
``serve.create_server``, ``train.fit`` and ``python -m
wesup_tpu_torch.train``, the inference CLIs ``python -m
wesup_tpu_torch.{infer,infer_tile,pixel_infer,pixel_infer_tile,
test_glas,test_dp2019_pipeline}``, ``models.steps.make_predict_step``/
``make_scaled_predict_step``/``make_train_step``/``make_eval_step``) run
on ``cuda`` unless the caller
passes ``device="cpu"``; with no CUDA device and no device given they raise
instead of falling back to the CPU.
"""

__version__ = "0.1.0"
