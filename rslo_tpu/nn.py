"""A minimal module layer: the subset of the Flax ``linen`` API that the
models use, on plain JAX.

Modules are dataclasses.  A module's variables live in nested dicts keyed
by collection ("params", "batch_stats"), then by module path, then by
variable name — the same tree Flax builds, so checkpoints and the
param-surgery rules address the same paths.  Submodules created inside a
``@compact`` method are named ``<ClassName>_<n>`` in creation order;
submodules assigned in ``setup`` take their attribute name.

Supported: ``Module`` (``init``, ``apply(method=, mutable=, rngs=)``,
``param``, ``variable``, ``make_rng``, ``is_initializing``), ``compact``,
``setup``, ``Dense``, ``Conv``, ``Dropout``, ``max_pool``, ``avg_pool``,
``remat(static_argnums=...)``, and ``jax.nn``'s activations and
initializers.
"""
from __future__ import annotations

import copy
import dataclasses
import functools
import threading
import types
import zlib
from typing import Any, Callable, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

initializers = jax.nn.initializers
relu = jax.nn.relu
elu = jax.nn.elu
sigmoid = jax.nn.sigmoid

_ctx = threading.local()


def _stack() -> list:
    if not hasattr(_ctx, "stack"):
        _ctx.stack = []
    return _ctx.stack


def _hash(s: str) -> int:
    return zlib.crc32(s.encode())


def _copy_dicts(tree):
    """Copy the dict structure of a variable tree (leaves shared)."""
    if isinstance(tree, dict):
        return {k: _copy_dicts(v) for k, v in tree.items()}
    return tree


class _Root:
    """State of one ``init``/``apply`` call."""

    def __init__(self, variables, rngs, mutable, initializing: bool):
        self.variables = {c: _copy_dicts(t) for c, t in variables.items()}
        self.rngs = rngs
        self.mutable = mutable
        self.initializing = initializing
        self.rng_counters: dict = {}

    def is_mutable(self, col: str) -> bool:
        return self.initializing or col in self.mutable


class _Scope:
    def __init__(self, root: _Root, path: tuple):
        self.root = root
        self.path = path

    def child(self, name: str) -> "_Scope":
        return _Scope(self.root, self.path + (name,))

    def node(self, col: str, create: bool):
        d = self.root.variables.get(col)
        if d is None:
            if not create:
                return None
            d = self.root.variables[col] = {}
        for p in self.path:
            nxt = d.get(p)
            if nxt is None:
                if not create:
                    return None
                nxt = d[p] = {}
            d = nxt
        return d

    def make_rng(self, name: str) -> jax.Array:
        rngs = self.root.rngs
        key = rngs.get(name, rngs.get("params"))
        if key is None:
            raise ValueError(f"no rng stream {name!r} was provided")
        cnt_key = (self.path, name)
        n = self.root.rng_counters.get(cnt_key, 0)
        self.root.rng_counters[cnt_key] = n + 1
        key = jax.random.fold_in(key, _hash("/".join(self.path)))
        return jax.random.fold_in(key, n)

    def rewind(self):
        for k in [k for k in self.root.rng_counters if k[0] == self.path]:
            del self.root.rng_counters[k]


class Variable:
    """A mutable handle on one variable (``.value``)."""

    def __init__(self, scope: _Scope, col: str, name: str):
        self._nn_scope, self._col, self._name = scope, col, name

    @property
    def value(self):
        return self._nn_scope.node(self._col, False)[self._name]

    @value.setter
    def value(self, v):
        if not self._nn_scope.root.is_mutable(self._col):
            raise ValueError(f"collection {self._col!r} is immutable; pass "
                             f"mutable=[{self._col!r}] to apply")
        self._nn_scope.node(self._col, True)[self._name] = v


def compact(fn: Callable) -> Callable:
    """Mark a method that defines submodules inline."""
    fn._compact = True
    return fn


def _wrap_method(fn: Callable) -> Callable:
    is_compact = getattr(fn, "_compact", False)

    @functools.wraps(fn)
    def wrapped(self, *args, **kwargs):
        self._nn_ensure_bound()
        stack = _stack()
        stack.append(self)
        try:
            return fn(self, *args, **kwargs)
        finally:
            stack.pop()
            if is_compact:
                # a second call reuses the same child names (and thus
                # the same variables), like a shared layer
                self._nn_autonames.clear()
                self._nn_scope.rewind()

    wrapped._compact = is_compact
    return wrapped


@dataclasses.dataclass(eq=False)
class Module:
    name: str | None = dataclasses.field(default=None, kw_only=True)

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        fields = cls.__dict__.get("__annotations__", {})
        for k, v in list(cls.__dict__.items()):
            if (isinstance(v, types.FunctionType) and k != "setup" and
                    k not in fields and
                    (k == "__call__" or not k.startswith("__"))):
                setattr(cls, k, _wrap_method(v))
        dataclasses.dataclass(cls, eq=False)

    def __post_init__(self):
        stack = _stack()
        parent = stack[-1] if stack else None
        object.__setattr__(self, "_nn_parent", parent)
        object.__setattr__(self, "_nn_scope", None)
        object.__setattr__(self, "_nn_autonames", {})
        object.__setattr__(self, "_nn_in_setup", False)
        if (parent is not None and self.name is None and
                not parent._nn_in_setup):
            prefix = type(self).__name__
            n = parent._nn_autonames.get(prefix, 0)
            parent._nn_autonames[prefix] = n + 1
            object.__setattr__(self, "name", f"{prefix}_{n}")

    def __setattr__(self, key, value):
        # submodules assigned in setup take the attribute's name
        if (isinstance(value, Module) and value.name is None and
                getattr(self, "_nn_in_setup", False)):
            object.__setattr__(value, "name", key)
        object.__setattr__(self, key, value)

    def setup(self):
        pass

    def _nn_run_setup(self):
        object.__setattr__(self, "_nn_in_setup", True)
        stack = _stack()
        stack.append(self)
        try:
            self.setup()
        finally:
            stack.pop()
            object.__setattr__(self, "_nn_in_setup", False)

    def _nn_ensure_bound(self):
        if self._nn_scope is not None:
            return
        if self._nn_parent is None:
            raise ValueError(f"{type(self).__name__} is not bound: call it "
                             f"through init/apply")
        self._nn_parent._nn_ensure_bound()
        object.__setattr__(self, "_nn_scope",
                           self._nn_parent._nn_scope.child(self.name))
        self._nn_run_setup()

    # ---- variables ------------------------------------------------------
    def is_initializing(self) -> bool:
        return self._nn_scope.root.initializing

    def param(self, name: str, init_fn: Callable, *init_args):
        scope = self._nn_scope
        node = scope.node("params", False)
        if node is not None and name in node:
            return node[name]
        if not scope.root.initializing:
            raise KeyError(f"param {'/'.join(scope.path + (name,))} "
                           f"is missing")
        key = jax.random.fold_in(
            scope.root.rngs["params"],
            _hash("/".join(scope.path + (name,))))
        value = init_fn(key, *init_args)
        scope.node("params", True)[name] = value
        return value

    def variable(self, col: str, name: str, init_fn: Callable,
                 *init_args) -> Variable:
        scope = self._nn_scope
        node = scope.node(col, False)
        if node is None or name not in node:
            if not scope.root.is_mutable(col):
                raise KeyError(f"variable {col}/"
                               f"{'/'.join(scope.path + (name,))} is "
                               f"missing")
            scope.node(col, True)[name] = init_fn(*init_args)
        return Variable(scope, col, name)

    def make_rng(self, name: str = "params") -> jax.Array:
        return self._nn_scope.make_rng(name)

    # ---- entry points ---------------------------------------------------
    def _nn_bound_clone(self, root: _Root) -> "Module":
        m = copy.copy(self)
        object.__setattr__(m, "_nn_parent", None)
        object.__setattr__(m, "_nn_scope", _Scope(root, ()))
        object.__setattr__(m, "_nn_autonames", {})
        m._nn_run_setup()
        return m

    def _nn_run(self, root: _Root, args, kwargs, method):
        if method is None:
            fn = type(self).__call__
        elif isinstance(method, str):
            fn = getattr(type(self), method)
        else:
            fn = getattr(method, "__func__", method)
        stack = _stack()
        saved = list(stack)
        stack.clear()   # a root call never has an enclosing module
        try:
            return fn(self._nn_bound_clone(root), *args, **kwargs)
        finally:
            stack[:] = saved

    def init(self, rngs, *args, method=None, **kwargs) -> dict:
        if not isinstance(rngs, dict):
            rngs = {"params": rngs}
        root = _Root({}, rngs, (), initializing=True)
        self._nn_run(root, args, kwargs, method)
        return root.variables

    def apply(self, variables: dict, *args, rngs: dict | None = None,
              method=None, mutable: Sequence[str] = (), **kwargs):
        """Run ``method`` (default ``__call__``) with ``variables``;
        with ``mutable`` collections, also return their new values."""
        root = _Root(variables, dict(rngs or {}), tuple(mutable),
                     initializing=False)
        out = self._nn_run(root, args, kwargs, method)
        if not mutable:
            return out
        return out, {c: root.variables.get(c, {}) for c in mutable}


# ---- layers ------------------------------------------------------------

def _promote(*args, dtype=None):
    if dtype is None:
        dtype = jnp.result_type(*[a for a in args if a is not None])
        if not jnp.issubdtype(dtype, jnp.inexact):
            dtype = jnp.float32
    return [None if a is None else jnp.asarray(a, dtype) for a in args]


class Dense(Module):
    features: int
    use_bias: bool = True
    kernel_init: Callable = initializers.lecun_normal()
    bias_init: Callable = initializers.zeros

    def __call__(self, inputs):
        kernel = self.param("kernel", self.kernel_init,
                            (inputs.shape[-1], self.features), jnp.float32)
        bias = (self.param("bias", self.bias_init, (self.features,),
                           jnp.float32) if self.use_bias else None)
        inputs, kernel, bias = _promote(inputs, kernel, bias)
        y = lax.dot_general(inputs, kernel,
                            (((inputs.ndim - 1,), (0,)), ((), ())))
        if bias is not None:
            y = y + jnp.reshape(bias, (1,) * (y.ndim - 1) + (-1,))
        return y


def _tuple(x, n: int) -> tuple:
    return (x,) * n if isinstance(x, int) else tuple(x)


class Conv(Module):
    """N-d convolution over channels-last inputs (HWIO kernel); padding
    is a string lax understands ("SAME", "VALID")."""
    features: int
    kernel_size: Sequence[int]
    strides: Any = 1
    padding: str = "SAME"
    feature_group_count: int = 1
    use_bias: bool = True
    dtype: Any = None
    param_dtype: Any = jnp.float32
    kernel_init: Callable = initializers.lecun_normal()
    bias_init: Callable = initializers.zeros

    def __call__(self, inputs):
        ks = _tuple(self.kernel_size, 1)
        nsp = len(ks)
        batch_shape = inputs.shape[:inputs.ndim - nsp - 1]
        x = inputs.reshape((-1,) + inputs.shape[len(batch_shape):])
        cin = x.shape[-1]
        kernel = self.param("kernel", self.kernel_init,
                            ks + (cin // self.feature_group_count,
                                  self.features), self.param_dtype)
        bias = (self.param("bias", self.bias_init, (self.features,),
                           self.param_dtype) if self.use_bias else None)
        x, kernel, bias = _promote(x, kernel, bias, dtype=self.dtype)
        nd = x.ndim
        lhs = (0, nd - 1) + tuple(range(1, nd - 1))
        rhs = (nd - 1, nd - 2) + tuple(range(0, nd - 2))
        y = lax.conv_general_dilated(
            x, kernel, _tuple(self.strides, nsp), self.padding,
            dimension_numbers=lax.ConvDimensionNumbers(lhs, rhs, lhs),
            feature_group_count=self.feature_group_count)
        if bias is not None:
            y = y + bias.reshape((1,) * (y.ndim - 1) + (-1,))
        return y.reshape(batch_shape + y.shape[1:])


class Dropout(Module):
    """Inverted dropout drawing from the "dropout" rng stream."""
    rate: float
    deterministic: bool = False

    def __call__(self, inputs):
        if self.rate == 0.0 or self.deterministic:
            return inputs
        if self.rate == 1.0:
            return jnp.zeros_like(inputs)
        keep = 1.0 - self.rate
        mask = jax.random.bernoulli(self.make_rng("dropout"),
                                    p=keep, shape=inputs.shape)
        return lax.select(mask, inputs / keep, jnp.zeros_like(inputs))


def _pool(x, init, reduce_fn, window_shape, strides, padding: str):
    """Pool the spatial axes of a (batch, *spatial, channels) array."""
    strides = tuple(strides) if strides else (1,) * len(window_shape)
    return lax.reduce_window(x, init, reduce_fn,
                             (1,) + tuple(window_shape) + (1,),
                             (1,) + strides + (1,), padding)


def max_pool(inputs, window_shape, strides=None, padding: str = "VALID"):
    return _pool(inputs, -jnp.inf, lax.max, window_shape, strides, padding)


def avg_pool(inputs, window_shape, strides=None, padding: str = "VALID"):
    """Average pooling; padded cells count in the divisor."""
    y = _pool(inputs, 0.0, lax.add, window_shape, strides, padding)
    return y / np.prod(window_shape)


def remat(target: type, static_argnums: Sequence[int] = ()) -> type:
    """Rematerialize ``target.__call__`` in the backward pass.

    ``static_argnums`` counts the module itself as argument 0.  Mutable
    collections written inside (BatchNorm statistics) are carried out of
    the checkpointed function as outputs.
    """
    static = {i - 1 for i in static_argnums}

    def __call__(self, *args):
        scope = self._nn_scope
        if scope.root.initializing:
            return target.__call__(self, *args)
        cols = [c for c in scope.root.variables
                if c != "params" and scope.root.is_mutable(c)]
        before = {c: _copy_dicts(scope.node(c, False) or {}) for c in cols}
        dyn = [i for i in range(len(args)) if i not in static]

        def f(*dyn_args):
            full = list(args)
            for i, a in zip(dyn, dyn_args):
                full[i] = a
            out = target.__call__(self, *full)
            after = {c: _copy_dicts(scope.node(c, False) or {})
                     for c in cols}
            for c in cols:     # leave no inner values behind
                _replace(scope.node(c, True), before[c])
            return out, after

        out, after = jax.checkpoint(f, prevent_cse=True)(
            *[args[i] for i in dyn])
        for c in cols:
            _replace(scope.node(c, True), after[c])
        return out

    return type(target.__name__, (target,), {"__call__": __call__,
                                             "__module__": __name__})


def _replace(node: dict, tree: dict):
    node.clear()
    node.update(_copy_dicts(tree))
