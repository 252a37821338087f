"""Every flag of paddle_tpu_torch/flags.py is documented.

Port of tools/check_flags_doc.py: each declared flag must appear by its
full ``PADDLE_TPU_TORCH_<NAME>`` spelling in README.md's port section
and in ``FLAGS.help()``, with a non-empty help string.  Catches a knob
added without documentation.

``python -m paddle_tpu_torch.tools.check_flags_doc`` (exit 1 on an
error).
"""
import importlib.util
import os

from . import PACKAGE, port_section, read_readme, run_main


def pristine_flags():
    """A fresh, private instance of paddle_tpu_torch/flags.py: the flags
    the module declares, not what a long-lived process defined since."""
    spec = importlib.util.spec_from_file_location(
        '_check_flags_doc_audit', os.path.join(PACKAGE, 'flags.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def check(flags=None, readme=None):
    """Error strings (empty: clean).  ``flags`` (a ``_Flags``) and
    ``readme`` (its text) default to the package's and the repo's."""
    mod = pristine_flags()
    flags = flags if flags is not None else mod.FLAGS
    try:
        readme = readme if readme is not None else read_readme()
    except OSError as e:
        return ['cannot read README.md: %s' % e]
    section = port_section(readme)
    if not section:
        return ["README.md has no '## PyTorch/CUDA port' section"]
    defs = flags.definitions()
    if not defs:
        return ['the flag registry is empty: import order bug?']
    help_text = flags.help()
    errors = []
    for name, (_default, help_str) in sorted(defs.items()):
        env = mod.ENV_PREFIX + name.upper()
        if env not in section:
            errors.append('%s is not documented in README.md\'s port '
                          'section' % env)
        if env not in help_text:
            errors.append('%s is missing from FLAGS.help()' % env)
        if not (help_str or '').strip():
            errors.append('%s was declared with an empty help string'
                          % env)
    return errors


def main():
    return run_main('check_flags_doc', check(),
                    '%d flags documented in the README\'s port section'
                    % len(pristine_flags().FLAGS.definitions()))


if __name__ == '__main__':
    raise SystemExit(main())
