"""har_tpu_torch — the PyTorch/CUDA port of har_tpu.

The JAX package ``har_tpu`` is the reference; this package mirrors its
module layout so each module's counterpart is found under the same name.
Importing the package is light: the CUDA kernels are built and loaded at
their first launch (``har_tpu_torch.ops._build``), never at import.

Entry points run on ``cuda`` unless the caller asks for ``cpu``:

    python -m har_tpu_torch.cli train            # lr dt rf, each with CV
"""

