"""Compare the flash kernels' float32 machine code with another checkout's.

    python3 -m paddle_tpu_torch.ops.kernels.sass_compare OTHER_CSRC_DIR

Run from the root of a checkout on a machine with nvcc.  It builds
``csrc/flash_attention_fwd.cu``, ``flash_attention_bwd.cu``,
``flash_attention_bwd_split.cu`` and ``flash_ceiling.cu`` of this
checkout (ops/kernels/build.py) and of OTHER_CSRC_DIR (another
checkout's ``csrc/``, its own headers beside them), one nvcc each, all
started together, and compares the SASS (``cuobjdump -sass``) of every
kernel function instantiated for float32 (#1-#4 and #11): the
instruction text, without addresses and encodings.  Prints one JSON line
per library ({function: 'equal' or the two instruction counts}), then
whether every float32 function is equal; exits 1 if one differs or is
missing on either side.
"""
import json
import os
import re
import subprocess
import sys

from . import build

__all__ = ['SOURCES', 'float32_functions', 'main']

SOURCES = ('flash_attention_fwd', 'flash_attention_bwd',
           'flash_attention_bwd_split', 'flash_ceiling')
# an instruction line of cuobjdump -sass: /*0a40*/ INSTR ... ; /* 0x... */
_INSTR = re.compile(r'^\s*/\*[0-9a-f]+\*/\s*(.*?)\s*;')


def float32_functions(sass):
    """{mangled name: [instruction text]} of the kernel functions in a
    ``cuobjdump -sass`` listing instantiated for float32 (template
    arguments starting ``If``); the hash nvcc gives each source's
    anonymous namespace (``_GLOBAL__N__<hex>_``, which depends on the
    path) is dropped from the names."""
    out, fn = {}, None
    for line in sass.splitlines():
        if 'Function : ' in line:
            name = re.sub(r'_GLOBAL__N__[0-9a-f]+_', '_GLOBAL__N__',
                          line.split('Function : ')[1].strip())
            fn = name if re.search(r'kernelIf', name) else None
            if fn:
                out[fn] = []
        elif fn:
            m = _INSTR.match(line)
            if m:
                out[fn].append(m.group(1))
    return out


def _sass(path):
    cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()),
                             'cuobjdump')
    return subprocess.run([cuobjdump, '-sass', path], capture_output=True,
                          text=True, timeout=300, check=True).stdout


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print(__doc__.strip().splitlines()[2], file=sys.stderr)
        return 2
    other = os.path.abspath(argv[0])
    build.load_all(SOURCES)
    all_equal = True
    for name in SOURCES:
        libs, _ = build.build_variants(
            name, {}, sources={'other': os.path.join(other, name + '.cu')})
        del libs
        mine = float32_functions(_sass(build.library_path(name)))
        theirs = float32_functions(_sass(os.path.join(
            build.BUILD_DIR, 'probe', '%s_other.so' % name)))
        result = {}
        for fn in sorted(set(mine) | set(theirs)):
            a, b = mine.get(fn), theirs.get(fn)
            if a is not None and a == b:
                result[fn] = 'equal'
            else:
                all_equal = False
                result[fn] = dict(this=None if a is None else len(a),
                                  other=None if b is None else len(b))
        print(json.dumps({name: result}))
    print(json.dumps({'float32_sass_equal': all_equal}))
    return 0 if all_equal else 1


if __name__ == '__main__':
    sys.exit(main())
