"""The peak memory and step p50 of chip_smoke.py's training
configurations, run on the card from one tree, each from a freed card.

    python3 tests/torch_liveness_peaks.py [--tree DIR]

DIR (default: this checkout) holds a ``chip_smoke.py`` and the
``paddle_tpu_torch/`` it drives.  The script imports DIR's chip_smoke,
builds DIR's kernels (its phase 2) and runs DIR's training phases: 9
(the transformer at T=512), 14 (the LSTM LM), 20 (seq2seq), 28
(ResNet-50), 32 (VGG-16) and 26 (the transformer at T=131072), freeing
the card between them; each phase resets the peak before its steps.  It
prints one JSON line, ``{"tree": ..., "card": ..., "configs": {name:
{"peak_gb", "step_ms_p50"}}}``.  To compare two trees on one card, unpack
the other commit (``git archive``) into a directory that .gitignore
lists and run the script once for each tree on the same card, in
turns.  Needs one CUDA card and nvcc; about two minutes a tree on an
H100.
"""
import argparse
import gc
import importlib
import json
import os
import sys


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--tree', default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    tree = os.path.abspath(ap.parse_args().tree)
    sys.path.insert(0, tree)
    cs = importlib.import_module('chip_smoke')
    import torch
    if not torch.cuda.is_available():
        print("torch_liveness_peaks: torch sees no CUDA device",
              file=sys.stderr)
        return 1
    card = cs.phase_environment()
    cs.phase_build()
    runs = [
        ('training_T512', lambda: cs.phase_training()),
        ('lm_training', cs.phase_lm_training),
        ('seq2seq_training', cs.phase_s2s_training),
        ('resnet50_training', cs.phase_resnet_training),
        ('vgg16_training', cs.phase_vgg_training),
        ('long_context_training', lambda: cs.phase_training(
            cs.LONG, 'long-context training', cs.SEED + 20,
            ('flash_attention_bwd_dkv', 'flash_attention_bwd_dq'))),
    ]
    out = {}
    for name, run in runs:
        res = run()
        out[name] = dict(peak_gb=res['max_memory_allocated'] / 1e9,
                         step_ms_p50=res['step_ms_p50'],
                         step_ms=res['step_ms'])
        del res
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    print(json.dumps({'tree': tree, 'card': card, 'configs': out}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
