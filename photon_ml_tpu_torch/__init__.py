"""PyTorch/CUDA port of photon_ml_tpu for NVIDIA Hopper (H100).

The package mirrors the module paths of ``photon_ml_tpu`` (the JAX
reference, which it never imports): ``photon_ml_tpu_torch/ops/losses.py``
ports ``photon_ml_tpu/ops/losses.py``, and so on. Public functions keep
the JAX layouts (``[E, n_pad, d_pad]`` entity blocks, ``[E, d]``
coefficients, ``[n]`` rows) so parity tests compare like with like.

Entry points take an explicit ``device`` that defaults to ``"cuda"`` and
raise when CUDA is absent unless the caller passes ``device="cpu"``.
The per-entity solve runs as a hand-written CUDA kernel
(``csrc/entity_lbfgs.cu``), and the gather experiment's two kernels as
``csrc/gather_onehot.cu`` and ``csrc/gather_residue.cu``, the sparse
fixed effect's products as ``csrc/csr_spmv.cu`` (a CSR product whose
additions run in an order fixed by each row's own length,
``csrc/csr_order.cuh``) and the batched λ grid's and streamed matrix
factorization's panel products as ``csrc/csr_spmm.cu`` (the same kernel
and order, column by column), on CUDA tensors; on CPU tensors each runs as
its plain PyTorch version. Avro decodes through a copy of the JAX
package's C decoder (``native/``), built at first use, in this process
or in ``python -m photon_ml_tpu_torch.data.parallel_ingest`` workers
that import no torch.
"""
