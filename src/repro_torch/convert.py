"""Parameter conversion from the reference package's layout.

``params_from_jax_numpy`` takes the JAX ``LM``'s parameter tree with every
leaf already turned into a numpy array (``jax.tree.map(np.asarray, ...)``)
and returns the port's tree, key for key. bf16 leaves arrive as numpy
arrays of the ``bfloat16`` extension type; they go through float32 to
``torch.bfloat16``, which is exact both ways. Neither JAX nor the extension
package is imported here."""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.device import DeviceLike


def _leaf(a: np.ndarray, device: DeviceLike) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t if device is None else t.to(device)


def params_from_jax_numpy(tree: Mapping[str, Any],
                          device: DeviceLike = None) -> dict:
    """Nested dict of numpy arrays -> nested dict of tensors (on ``device``
    when given, else the CPU)."""
    return {k: params_from_jax_numpy(v, device) if isinstance(v, Mapping)
            else _leaf(v, device) for k, v in tree.items()}
