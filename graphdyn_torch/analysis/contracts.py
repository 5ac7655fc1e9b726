"""Shape and dtype contracts for the port's entry points (the port of
``graphdyn/analysis/contracts.py``: the same decorator, spec grammar and
error type).

``@contract(s="int8[r,n]", nbr="int32[n,d]", ret="int8[r,n]")`` checks the
tensors flowing through a function against a compact spec language. The
JAX package runs the check once per trace; the port has no tracer, so the
check runs at every call, on tensor metadata only (``.dtype`` and
``.shape``): it never reads device data, never calls ``.item()`` and never
synchronises with the card, and an argument that violates its spec raises
:class:`ContractError` before the function body (and any kernel launch)
runs.

This is the runtime half of the dtype contract that ``graftlint`` GD004
enforces statically: the linter catches literal violations in the source,
the contract catches the ones that arrive through an argument — an int64
neighbour table from an unconverted host build, a float64 chi from a
caller, a transposed state.

Spec grammar (one string per argument; ``ret`` is the return value)::

    spec    := dtypes | dtypes "[" dims "]"
    dtypes  := "*" | name ("|" name)*      # "*" = any dtype
    dims    := ""                          # "[]" = rank-0 scalar
             | dim ("," dim)*
    dim     := INT                         # exact size
             | "_"                         # any size
             | SYMBOL                      # binds; must agree across args

Dtype names are torch's (``int8``, ``int32``, ``float32``, ``bool``, ...)
with the JAX package's short aliases (``f32``→float32, ``i8``→int8,
``u32``→uint32, ``bool``/``bool_``). The port's packed spin words are
``int32`` tensors carrying the reference's uint32 bit patterns, so a JAX
``uint32`` spec is ``int32`` here. A bare ``dtypes`` spec (no brackets)
checks dtype only and leaves the rank free. Symbols bind left to right
across the argument list and the return value, so ``s="int8[r,n]",
nbr="int32[n,d]"`` enforces that the state's node axis matches the
neighbour table's rows.

Tuple returns: give ``ret`` a tuple of specs (checked positionally;
``None`` skips an element).
"""

from __future__ import annotations

import functools
import inspect
import re

__all__ = ["contract", "ContractError"]


class ContractError(TypeError):
    """An argument or return value violated its @contract spec."""


_ALIASES = {
    "f16": "float16", "f32": "float32", "f64": "float64",
    "bf16": "bfloat16",
    "i8": "int8", "i16": "int16", "i32": "int32", "i64": "int64",
    "u8": "uint8", "u16": "uint16", "u32": "uint32", "u64": "uint64",
    "bool": "bool_",
}
_SPEC_RE = re.compile(r"^\s*([^\[\]]+?)\s*(\[(.*)\])?\s*$")
_SYM_RE = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")


def _canon_dtype(name: str) -> str:
    name = name.strip()
    return _ALIASES.get(name, name)


def _parse_spec(spec: str):
    """-> (dtypes: tuple[str] | None, dims: tuple | None).

    dtypes None means any dtype; dims None means any rank, () rank-0.
    """
    m = _SPEC_RE.match(spec)
    if not m:
        raise ValueError(f"malformed contract spec {spec!r}")
    dt_part, has_dims, dims_part = m.group(1), m.group(2), m.group(3)
    if dt_part.strip() == "*":
        dtypes = None
    else:
        dtypes = tuple(_canon_dtype(t) for t in dt_part.split("|"))
        for t in dtypes:
            if not _SYM_RE.match(t.replace("bool_", "bool")):
                raise ValueError(f"bad dtype {t!r} in contract spec {spec!r}")
    if not has_dims:
        return dtypes, None
    dims = []
    if dims_part.strip():
        for tok in dims_part.split(","):
            tok = tok.strip()
            if not tok:
                raise ValueError(f"empty dim in contract spec {spec!r}")
            if tok.isdigit():
                dims.append(int(tok))
            elif tok == "_" or _SYM_RE.match(tok):
                dims.append(tok)
            else:
                raise ValueError(f"bad dim {tok!r} in contract spec {spec!r}")
    return dtypes, tuple(dims)


def _dtype_name(dt) -> str:
    """``torch.int8`` -> ``int8`` (a numpy dtype's name as it is), with
    torch's ``bool`` under the grammar's canonical ``bool_``."""
    name = str(dt)
    name = name[len("torch."):] if name.startswith("torch.") else name
    return "bool_" if name == "bool" else name


def _describe(x) -> str:
    dt = getattr(x, "dtype", None)
    sh = getattr(x, "shape", None)
    if dt is None or sh is None:
        return f"{type(x).__name__} (not an array)"
    return f"{dt}[{', '.join(map(str, sh))}]"


def _check_value(fname, where, x, dtypes, dims, env):
    if isinstance(x, (bool, int, float, complex)):
        # Python scalars are weakly typed (a float becomes the tensor's
        # float dtype): accept them when any allowed dtype shares their
        # kind, and check rank only
        kind = ("bool" if isinstance(x, bool)
                else "int" if isinstance(x, int)
                else "float" if isinstance(x, float) else "complex")
        if dtypes is not None and not any(kind in t or t == "bool_" and
                                          kind == "bool" for t in dtypes):
            raise ContractError(
                f"{fname}: {where} is a Python {kind} scalar, contract "
                f"requires {'|'.join(dtypes)}"
            )
        if dims not in (None, ()):
            raise ContractError(
                f"{fname}: {where} is a scalar, contract requires rank "
                f"{len(dims)} {dims}"
            )
        return
    dt = getattr(x, "dtype", None)
    sh = getattr(x, "shape", None)
    if dt is None or sh is None:
        raise ContractError(
            f"{fname}: {where} must be an array-like with shape/dtype, got "
            f"{type(x).__name__}"
        )
    if dtypes is not None and _dtype_name(dt) not in dtypes:
        raise ContractError(
            f"{fname}: {where} has dtype {dt}, contract requires "
            f"{'|'.join(dtypes)} (got {_describe(x)})"
        )
    if dims is None:
        return
    if len(sh) != len(dims):
        raise ContractError(
            f"{fname}: {where} has rank {len(sh)}, contract requires rank "
            f"{len(dims)} {dims} (got {_describe(x)})"
        )
    for axis, (want, got) in enumerate(zip(dims, sh)):
        got = int(got)
        if want == "_":
            continue
        if isinstance(want, int):
            if got != want:
                raise ContractError(
                    f"{fname}: {where} axis {axis} has size {got}, contract "
                    f"requires {want} (got {_describe(x)})"
                )
        else:
            bound = env.setdefault(want, (got, where, axis))
            if bound[0] != got:
                raise ContractError(
                    f"{fname}: {where} axis {axis} has size {got}, but "
                    f"symbol {want!r} was bound to {bound[0]} by {bound[1]} "
                    f"axis {bound[2]}"
                )


def contract(ret=None, **arg_specs):
    """Decorator: check tensor args/returns against spec strings at every
    call, from their metadata.  See the module docstring for the grammar.  ``ret`` takes the
    return-value spec (a string, or a tuple of strings/None for tuple
    returns).  Unspecified parameters are unchecked (static/config args need
    no spec)."""
    parsed_args = {k: _parse_spec(v) for k, v in arg_specs.items()}
    if ret is None:
        ret_kind, parsed_ret = None, None
    elif isinstance(ret, (tuple, list)):
        ret_kind = "tuple"
        parsed_ret = tuple(
            None if s is None else _parse_spec(s) for s in ret
        )
    else:
        ret_kind, parsed_ret = "single", _parse_spec(ret)

    def deco(fn):
        sig = inspect.signature(fn)
        unknown = set(parsed_args) - set(sig.parameters)
        if unknown:
            raise ValueError(
                f"@contract on {fn.__qualname__}: specs for unknown "
                f"parameter(s) {sorted(unknown)}"
            )

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            fname = fn.__qualname__
            try:
                bound = sig.bind(*args, **kwargs)
            except TypeError:
                return fn(*args, **kwargs)   # let fn raise its own error
            env: dict = {}
            for name, (dtypes, dims) in parsed_args.items():
                if name in bound.arguments:
                    _check_value(fname, f"argument {name!r}",
                                 bound.arguments[name], dtypes, dims, env)
            out = fn(*args, **kwargs)
            if parsed_ret is not None:
                if ret_kind == "tuple":
                    if not isinstance(out, (tuple, list)) or len(out) != len(
                        parsed_ret
                    ):
                        raise ContractError(
                            f"{fname}: return value is not a {len(parsed_ret)}"
                            f"-tuple (contract gave a tuple of specs)"
                        )
                    for i, spec in enumerate(parsed_ret):
                        if spec is not None:
                            _check_value(fname, f"return[{i}]", out[i],
                                         spec[0], spec[1], env)
                else:
                    _check_value(fname, "return value", out,
                                 parsed_ret[0], parsed_ret[1], env)
            return out

        return wrapper

    return deco
