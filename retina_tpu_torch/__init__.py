"""retina_tpu_torch: the PyTorch/CUDA port of retina_tpu for one NVIDIA H100.

The module tree mirrors ``retina_tpu/``: the same relative path names the
JAX reference a module ports. State keeps the reference's field names,
shapes and seeds, and hashes are bit-identical, so a state carried across
(``convert.py``) continues identically on either side.

Conventions:

- **u32 as int32.** PyTorch's CPU ``uint32`` lacks shifts, adds, compares
  and scatters, so every u32 state leaf is a ``torch.int32`` tensor holding
  the u32 bit pattern (``u32.py``). Readout to numpy is
  ``.numpy().view(np.uint32)``; the CUDA kernels reinterpret the pointers
  as ``uint32_t*``; the plain versions compute in ``int64 & 0xFFFFFFFF``
  and store back as int32 (int32 adds wrap mod 2^32 like u32 adds).
- **No CPU fallback.** Entry points run on the card unless the caller
  passes ``device="cpu"``; without a card they raise. A kernel wrapper
  (``kernels/ops.py``) runs its plain PyTorch version only for tensors
  that lie on the CPU; on a CUDA tensor it launches the hand-written
  kernel or raises.
- **In place.** Step, window close and the sketch updates mutate the
  state tensors in place (the kernels update with atomics); a snapshot
  copies what it returns.

The package imports torch and numpy only: never JAX, and nothing of
``retina_tpu``.
"""
