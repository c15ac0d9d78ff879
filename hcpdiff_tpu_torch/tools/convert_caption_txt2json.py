"""Per-image ``.txt`` captions -> one captions JSON {stem: caption} (a port
of ``hcpdiff_tpu/tools/convert_caption_txt2json.py``):

    python -m hcpdiff_tpu_torch.tools.convert_caption_txt2json --data_root imgs/ \\
        [--out_file imgs/image_captions.json]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Optional


def convert(data_root: str, out_file: Optional[str] = None) -> str:
    caps = {}
    for p in sorted(glob.glob(os.path.join(data_root, '*.txt'))):
        with open(p, encoding='utf-8') as f:
            caps[os.path.splitext(os.path.basename(p))[0]] = f.read().strip()
    out_file = out_file or os.path.join(data_root, 'image_captions.json')
    with open(out_file, 'w', encoding='utf-8') as f:
        json.dump(caps, f, ensure_ascii=False, indent=2)
    return out_file


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--data_root', required=True)
    p.add_argument('--out_file', default=None)
    a = p.parse_args(argv)
    out = convert(a.data_root, a.out_file)
    print(out)
    return out


if __name__ == '__main__':
    main()
