"""proudslam_tpu_torch — the PyTorch + CUDA port of the SLAM engine.

A second package beside ``proudslam_tpu`` (the JAX reference). Plain
tensor code is PyTorch; the render hot loop runs through CUDA C++ kernels
written for Hopper (``csrc/``): the fused sample-feature + decoder forward
(``ops/kernels/render_kernel.py``, the vox branch), and the fused decoder
forward and backward (``ops/kernels/mlp_kernel.py``, the pcd branch's
decoder and both branches' backward) with bf16 operands on the tensor
cores or with f32 operands on the FP32 units. The configs under
``configs/`` run the unfused branch in plain PyTorch; ``run_slam.py`` is
the command line (``python -m proudslam_tpu_torch.run_slam``). This
package never imports JAX.
"""

__version__ = "0.1.0"

import torch as _torch

# Geometry runs through matmuls (``dirs @ R.T``, point transforms, pose
# composition). TF32 keeps ~10 mantissa bits, which quantizes positions to
# ~0.1% — cm-class SLAM needs true f32. The decoder's reduced precision is
# explicit (bf16 operands inside the kernels), never a global switch.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from proudslam_tpu_torch.config import Config, load_config  # noqa: E402,F401
