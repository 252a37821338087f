"""Exporters: Prometheus text exposition and JSON snapshot.

Reference parity: paddle_tpu/observability/exporters.py, byte for byte in
what it renders.

Prometheus exposition format 0.0.4 — each metric family gets ``# HELP``
and ``# TYPE`` comment lines, then one sample line per child:

    paddle_tpu_serving_queue_depth{server="b0"} 3
    paddle_tpu_span_seconds_bucket{span="executor.run",le="+Inf"} 12

Every sample line matches ``^[a-z_]+(\\{[^}]*\\})? [0-9.eE+-]+$``: the
registry enforces digit-free metric names and the value formatter below
never emits inf/nan (histogram +Inf lives in the ``le`` label, and
min/max are snapshot-only fields, not samples).
"""
import json
import math

from .metrics import registry as _global_registry

__all__ = ['prometheus_text', 'json_snapshot']


def _fmt_value(v):
    """Render a sample value: integers without a trailing .0 (bucket and
    counter lines read as counts), floats via repr (shortest round-trip,
    exponent form matches [0-9.eE+-]+).  Non-finite values — possible
    only via user-set gauges / observations, never from the built-in
    instrumentation — render in the Prometheus spellings."""
    f = float(v)
    if math.isinf(f):
        return '+Inf' if f > 0 else '-Inf'
    if math.isnan(f):
        return 'NaN'
    if f == int(f) and abs(f) < 1e15:
        return '%d' % int(f)
    return repr(f)


def _fmt_le(ub):
    if ub == float('inf'):
        return '+Inf'
    return _fmt_value(ub)


def _escape_label(v):
    return str(v).replace('\\', r'\\').replace('\n', r'\n') \
                 .replace('"', r'\"')


def _label_str(names, values, extra=()):
    pairs = ['%s="%s"' % (n, _escape_label(v))
             for n, v in zip(names, values)]
    pairs.extend('%s="%s"' % (n, _escape_label(v)) for n, v in extra)
    if not pairs:
        return ''
    return '{%s}' % ','.join(pairs)


def prometheus_text(reg=None):
    """Render a registry (default: the global one) in Prometheus text
    exposition format 0.0.4."""
    reg = reg or _global_registry()
    lines = []
    for m in reg.collect():
        if m.help:
            lines.append('# HELP %s %s'
                         % (m.name, m.help.replace('\n', ' ')))
        lines.append('# TYPE %s %s' % (m.name, m.kind))
        for key, child in m._samples():
            if m.kind == 'histogram':
                s = child.snapshot()
                for ub, cum in s['buckets']:
                    lines.append('%s_bucket%s %s' % (
                        m.name,
                        _label_str(m.labelnames, key,
                                   extra=(('le', _fmt_le(ub)),)),
                        _fmt_value(cum)))
                ls = _label_str(m.labelnames, key)
                lines.append('%s_sum%s %s'
                             % (m.name, ls, _fmt_value(s['sum'])))
                lines.append('%s_count%s %s'
                             % (m.name, ls, _fmt_value(s['count'])))
            else:
                lines.append('%s%s %s' % (
                    m.name, _label_str(m.labelnames, key),
                    _fmt_value(child.value)))
    return '\n'.join(lines) + '\n'


def _json_safe(obj):
    """Replace non-finite floats with their Prometheus spellings so the
    output stays strict JSON (bare Infinity/NaN is not)."""
    if isinstance(obj, float):
        if math.isinf(obj) or math.isnan(obj):
            return _fmt_value(obj)
        return obj
    if isinstance(obj, dict):
        return {k: _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    return obj


def json_snapshot(reg=None, indent=None):
    """The registry snapshot as a JSON string (the machine-readable
    sibling of the Prometheus text)."""
    reg = reg or _global_registry()
    return json.dumps(_json_safe(reg.snapshot()), indent=indent,
                      sort_keys=True)
