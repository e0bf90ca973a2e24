"""PyTorch/CUDA port of the Griffin serving stack.

Mirrors ``repro``'s module layout (``configs``, ``core``, ``kernels``,
``sparsity``, ``models``, ``runtime``, ``launch``) so each counterpart is
easy to find.  Imports torch and numpy only: what it needs from the JAX
package's pure-Python modules it keeps as its own copy.  Entry points run on
the CUDA card unless the caller passes ``device="cpu"``
(:func:`repro_torch.device.resolve_device`).
"""
