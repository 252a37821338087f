"""Scope: name -> tensor store for persistable state.

Reference parity: paddle_tpu/core/scope.py (paddle/framework/scope.h).
Values are torch tensors that stay on the executor's device between
Executor.run calls: parameters, optimizer moments, learning rates.  The
executor updates them in place.
"""
import contextlib

import numpy as np
import torch

from .place import resolve_device

__all__ = ['Scope', 'global_scope', 'scope_guard', 'scope_from_numpy']


class Scope(object):
    def __init__(self, parent=None):
        self._vars = {}
        self.parent = parent

    def find_var(self, name):
        s = self
        while s is not None:
            if name in s._vars:
                return s._vars[name]
            s = s.parent
        return None

    def has(self, name):
        return self.find_var(name) is not None

    def set(self, name, value):
        self._vars[name] = value

    def get(self, name):
        v = self.find_var(name)
        if v is None:
            raise KeyError("variable %r has no value in scope (did you run "
                           "the startup program?)" % name)
        return v

    def get_numpy(self, name):
        return self.get(name).detach().cpu().numpy()

    def erase(self, name):
        self._vars.pop(name, None)

    def local_var_names(self):
        return list(self._vars)


_global_scope = Scope()


def global_scope():
    return _global_scope


@contextlib.contextmanager
def scope_guard(scope):
    global _global_scope
    old = _global_scope
    _global_scope = scope
    try:
        yield
    finally:
        _global_scope = old


def scope_from_numpy(np_values, device=None, scope=None):
    """Copy ``{name: np.ndarray}`` (a reference scope's persistables
    through ``np.asarray``) into ``scope`` (a new Scope when None) as
    tensors on ``device`` (None: the card)."""
    device = resolve_device(device)
    scope = Scope() if scope is None else scope
    for name, a in np_values.items():
        scope.set(name, torch.from_numpy(np.array(a, copy=True)).to(device))
    return scope
