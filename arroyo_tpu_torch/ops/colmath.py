"""Column arithmetic for SQL-compiled expressions: numpy arrays, torch
tensors and Python scalars mixed with the promotion rules of ``jax.numpy``
under x64, which the JAX package's compiled expressions follow.

The SQL compiler's closures see three kinds of value.  Host columns
arrive as numpy arrays and stay numpy under Python operators, as they do
in the JAX package's host path.  Where the JAX compiler calls ``jnp``, the
port calls torch, so those results are tensors, as the JAX results are
jax arrays.  And a batch evaluated on the expression device arrives as
tensors.  Mixing them takes these rules, which are JAX's:

* a numpy array or numpy scalar meeting a tensor becomes a tensor of its
  own dtype (numpy scalars are strongly typed in JAX), and two tensors of
  different dtypes promote by ``torch.promote_types``, which agrees with
  JAX's lattice on the dtypes columns take (int with float gives the
  float, bool with int gives the int);
* a Python scalar is weakly typed: it takes the tensor's dtype, except a
  float meeting an integer or bool tensor, which gives float64 (torch
  would give its default float32);
* a true division or an "inexact" function of integers gives float64 for
  int64 and float32 for narrower integers and bool, as ``jnp`` does.

Nothing here moves a tensor between devices except numpy inputs, which
go to the device of the tensor they meet."""

from __future__ import annotations

import operator
from typing import Any, Optional, Tuple

import numpy as np
import torch


def is_tensor(x: Any) -> bool:
    return isinstance(x, torch.Tensor)


def from_numpy(a: Any, device: Optional[torch.device] = None
               ) -> torch.Tensor:
    """A numpy array as a tensor (a copy when the array is read-only,
    as batch columns often are: ``torch.from_numpy`` warns on those)."""
    a = np.asarray(a)
    if not a.flags.writeable:
        a = a.copy()
    t = torch.from_numpy(a)
    if device is not None and device.type != "cpu":
        t = t.to(device)
    return t


def to_numpy(x: Any) -> Any:
    """A tensor as a numpy array (read back from the card if it lives
    there); anything else as it is."""
    if is_tensor(x):
        return x.numpy() if x.device.type == "cpu" else x.cpu().numpy()
    return x


def device_of(*xs: Any) -> Optional[torch.device]:
    for x in xs:
        if is_tensor(x):
            return x.device
    return None


def lift(x: Any, device: torch.device) -> Any:
    """Numpy arrays and numpy scalars as tensors on ``device``; tensors
    and Python scalars unchanged."""
    if is_tensor(x):
        return x
    if isinstance(x, np.ndarray):
        if x.dtype == object:
            raise TypeError("object (string) columns do not enter torch")
        return from_numpy(x, device)
    if isinstance(x, np.generic):
        return torch.tensor(x.item(), dtype=torch_dtype(x.dtype),
                            device=device)
    return x


def as_tensor(x: Any, device: Optional[torch.device] = None
              ) -> torch.Tensor:
    """``jnp.asarray``: Python scalars take JAX's x64 defaults (bool,
    int64, float64); numpy keeps its dtype."""
    if is_tensor(x):
        return x
    dev = device or torch.device("cpu")
    if isinstance(x, (np.ndarray, np.generic)):
        return lift(x, dev)
    if isinstance(x, bool):
        return torch.tensor(x, dtype=torch.bool, device=dev)
    if isinstance(x, int):
        return torch.tensor(x, dtype=torch.int64, device=dev)
    if isinstance(x, float):
        return torch.tensor(x, dtype=torch.float64, device=dev)
    return from_numpy(np.asarray(x), dev)


_TORCH_OF = {np.dtype(np.bool_): torch.bool, np.dtype(np.uint8): torch.uint8,
             np.dtype(np.int8): torch.int8, np.dtype(np.int16): torch.int16,
             np.dtype(np.int32): torch.int32,
             np.dtype(np.int64): torch.int64,
             np.dtype(np.float16): torch.float16,
             np.dtype(np.float32): torch.float32,
             np.dtype(np.float64): torch.float64}


def torch_dtype(dt: Any) -> torch.dtype:
    return _TORCH_OF[np.dtype(dt)]


def inexact(dt: torch.dtype) -> torch.dtype:
    """The float dtype ``jnp`` gives an integer or bool input of an
    inexact function (sqrt, exp, true division)."""
    if dt.is_floating_point:
        return dt
    return torch.float64 if dt == torch.int64 else torch.float32


def _scalar_kind(x: Any) -> Optional[str]:
    if isinstance(x, bool):
        return "b"
    if isinstance(x, int):
        return "i"
    if isinstance(x, float):
        return "f"
    return None


def prep(a: Any, b: Any) -> Tuple[Any, Any]:
    """Both operands of a binary op made ready for torch with JAX's
    promotion; two non-tensors come back unchanged (numpy semantics, as
    the JAX host path has them)."""
    if not (is_tensor(a) or is_tensor(b)):
        return a, b
    dev = device_of(a, b)
    a, b = lift(a, dev), lift(b, dev)
    if is_tensor(a) and is_tensor(b):
        if a.dtype != b.dtype:
            dt = torch.promote_types(a.dtype, b.dtype)
            a, b = a.to(dt), b.to(dt)
        return a, b
    if is_tensor(a):
        if _scalar_kind(b) == "f" and not a.is_floating_point():
            a = a.to(torch.float64)
        return a, b
    if _scalar_kind(a) == "f" and not b.is_floating_point():
        b = b.to(torch.float64)
    return a, b


def _binary(fn):
    def op(a, b):
        a, b = prep(a, b)
        return fn(a, b)
    return op


add = _binary(operator.add)
sub = _binary(operator.sub)
mul = _binary(operator.mul)
floordiv = _binary(operator.floordiv)
eq = _binary(operator.eq)
ne = _binary(operator.ne)
lt = _binary(operator.lt)
le = _binary(operator.le)
gt = _binary(operator.gt)
ge = _binary(operator.ge)
and_ = _binary(operator.and_)
or_ = _binary(operator.or_)
xor = _binary(operator.xor)


def truediv(a: Any, b: Any) -> Any:
    """IEEE division, as numpy and ``jnp`` divide.  A Python scalar
    operand becomes a 0-d tensor on the other's device first: torch
    divides by a host scalar as a multiplication by its reciprocal on the
    card, and ``scalar / tensor`` as one everywhere, each a rounding off
    the quotient in some rows."""
    a, b = prep(a, b)
    if not is_tensor(a) and not is_tensor(b):
        return a / b
    t = a if is_tensor(a) else b
    dt = inexact(t.dtype)
    a = a.to(dt) if is_tensor(a) else torch.tensor(a, dtype=dt,
                                                   device=t.device)
    b = b.to(dt) if is_tensor(b) else torch.tensor(b, dtype=dt,
                                                   device=t.device)
    return torch.div(a, b)


def invert(v: Any) -> Any:
    """SQL NOT as the JAX compiler writes it (``~v``, else ``not v``)."""
    return ~v if hasattr(v, "__invert__") else (not v)


def tensors(*xs: Any) -> Tuple[torch.Tensor, ...]:
    """Every operand as a tensor on one device, promoted together
    (Python scalars weakly, as ``prep`` does)."""
    dev = device_of(*xs) or torch.device("cpu")
    ts = [lift(x, dev) for x in xs]
    strong = [t for t in ts if is_tensor(t)]
    if strong:
        dt = strong[0].dtype
        for t in strong[1:]:
            dt = torch.promote_types(dt, t.dtype)
        if not dt.is_floating_point and any(
                _scalar_kind(t) == "f" for t in ts):
            dt = torch.float64
        elif dt == torch.bool and any(_scalar_kind(t) == "i" for t in ts):
            dt = torch.int64
    else:
        kinds = {_scalar_kind(t) for t in ts}
        dt = (torch.float64 if "f" in kinds else torch.int64 if "i" in kinds
              else torch.bool)
    return tuple(t.to(dt) if is_tensor(t) else
                 torch.tensor(t, dtype=dt, device=dev) for t in ts)


def where(c: Any, a: Any, b: Any) -> torch.Tensor:
    """``jnp.where``: the result dtype is the promotion of ``a`` and ``b``
    (Python scalars weak)."""
    dev = device_of(c, a, b) or torch.device("cpu")
    ct = as_tensor(lift(c, dev), dev)
    if ct.dtype != torch.bool:
        ct = ct.to(torch.bool)
    at, bt = tensors(lift(a, dev) if not is_tensor(a) else a,
                      lift(b, dev) if not is_tensor(b) else b)
    if ct.device != at.device:
        ct = ct.to(at.device)
    return torch.where(ct, at, bt)


def astype(v: Any, dt: torch.dtype, device: Optional[torch.device] = None
           ) -> torch.Tensor:
    """``jnp.asarray(v).astype(dt)``."""
    return as_tensor(v, device).to(dt)


def unary_inexact(fn):
    """An inexact ``jnp`` function (sqrt, exp, sin, ...): integer and bool
    inputs go to float first."""
    def op(v):
        t = as_tensor(v)
        return fn(t.to(inexact(t.dtype)))
    return op


def sign(v: Any) -> torch.Tensor:
    """``jnp.sign``: NaN stays NaN and -0.0 stays -0.0 (torch.sign gives
    0.0 for both)."""
    t = as_tensor(v)
    if not t.is_floating_point():
        return torch.sign(t)
    return torch.where((t == 0) | torch.isnan(t), t, torch.sign(t))


def ndim(v: Any) -> int:
    return v.dim() if is_tensor(v) else np.ndim(v)


def shape(v: Any) -> Tuple[int, ...]:
    return tuple(v.shape) if is_tensor(v) else np.shape(v)
