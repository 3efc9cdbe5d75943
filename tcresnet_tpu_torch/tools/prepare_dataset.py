"""Prepare Google Speech Commands v1 in the layout the loader reads
(counterpart of tools/prepare_dataset.py; the same files land in the same
splits).

    python -m tcresnet_tpu_torch.tools.prepare_dataset --extracted <gsc dir> --out <tree>
    python -m tcresnet_tpu_torch.tools.prepare_dataset --archive speech_commands_v0.01.tar.gz \
        --out <tree>
    python -m tcresnet_tpu_torch.tools.prepare_dataset --extracted <gsc dir> --out <tree> \
        --split-lists <dir with train.txt, valid.txt, test.txt>

Builds `<out>/{train,valid,test}/<label>/` as symlinks (`--copy` copies):
the keywords under their own names, every other word as
`unknown/<word>_<file>`, and `_background_noise_` linked into each split;
silence is injected when a split is loaded (`--num-silent`), so it has
no directory. The split of each file is either

  --split-lists DIR  explicit train.txt / valid.txt / test.txt (one
                     `label/filename.wav` a line, in the source layout or
                     already as `unknown/<word>_<file>`), or
  (default)          the canonical GSC which_set(): a SHA1 hash of the
                     speaker id picks valid / test by percentage, plus a
                     seeded subsample of the unknown words per split.

No network access is assumed: pass --archive (a local tar file of the
dataset) or --extracted (an unpacked copy).
"""

from __future__ import annotations

import argparse
import hashlib
import random
import re
import sys
import tarfile
from pathlib import Path

KEYWORDS = ("yes", "no", "up", "down", "left", "right", "on", "off", "stop", "go")
BACKGROUND_DIR = "_background_noise_"
MAX_PER_CLASS = 2**27 - 1  # canonical which_set modulo


def which_set(filename: str, validation_pct: float, testing_pct: float) -> str:
    """Canonical GSC split: hash the speaker id (text before -nohash-)."""
    base = Path(filename).name
    speaker = re.sub(r"_nohash_.*$", "", base)
    h = hashlib.sha1(speaker.encode()).hexdigest()
    # canonical formula: modulo (MAX+1) but scaled by 100/MAX (NOT MAX+1),
    # so boundary files land in the same split as the published splitter
    pct = (int(h, 16) % (MAX_PER_CLASS + 1)) * (100.0 / MAX_PER_CLASS)
    if pct < validation_pct:
        return "valid"
    if pct < validation_pct + testing_pct:
        return "test"
    return "train"


def load_split_lists(split_dir: Path):
    splits = {}
    for split, fname in [("train", "train.txt"), ("valid", "valid.txt"), ("test", "test.txt")]:
        path = split_dir / fname
        if not path.exists():
            raise SystemExit(f"Missing split list {path}")
        splits[split] = [l.strip() for l in path.read_text().splitlines() if l.strip()]
    return splits


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--archive", default=None, help="speech_commands_v0.01.tar.gz")
    p.add_argument("--extracted", default=None, help="already-unpacked GSC dir")
    p.add_argument("--out", required=True)
    p.add_argument("--split-lists", default=None,
                   help="dir with train.txt/valid.txt/test.txt (relative "
                        "label/filename.wav lines)")
    p.add_argument("--validation-pct", type=float, default=10.0)
    p.add_argument("--testing-pct", type=float, default=10.0)
    p.add_argument("--unknown-pct", type=float, default=10.0,
                   help="unknown samples as %% of keyword count per split")
    p.add_argument("--seed", type=int, default=59185, help="unknown subsample seed")
    p.add_argument("--copy", action="store_true", help="copy instead of symlink")
    p.add_argument("--wanted-words", default=",".join(KEYWORDS),
                   help="comma-separated keyword classes; other words "
                        "become 'unknown' (reference --wanted_words, "
                        "scripts/google_speech_commmands_dataset_to_our_"
                        "format.py:31)")
    args = p.parse_args(argv)
    keywords = tuple(w for w in args.wanted_words.split(",") if w)

    if args.extracted:
        src = Path(args.extracted)
    elif args.archive:
        src = Path(args.out) / "_extracted"
        src.mkdir(parents=True, exist_ok=True)
        print(f"Extracting {args.archive} -> {src}")
        with tarfile.open(args.archive) as tf:
            tf.extractall(src, filter="data")
    else:
        raise SystemExit("Pass --archive or --extracted (no network egress).")

    if not any(src.glob("*/*.wav")):
        # archives unpack flat (label dirs at top level) - check nesting
        nested = [d for d in src.iterdir() if d.is_dir() and any(d.glob("*/*.wav"))]
        if len(nested) == 1:
            src = nested[0]
        else:
            raise SystemExit(f"No label/<wav> structure under {src}")

    out = Path(args.out)
    place = (lambda a, b: b.write_bytes(a.read_bytes())) if args.copy else (
        lambda a, b: b.symlink_to(a.resolve())
    )

    # assignment: filename -> (split, label-dir, out-name)
    assignments = []
    if args.split_lists:
        # Lines come in two layouts, both supported:
        #   source layout (the reference's shipped lists): raw GSC
        #   labels — `bed/x.wav` for non-keywords (remapped to
        #   unknown/bed_x.wav here) and `_silence_/x.wav` rows counted
        #   but not placed (silence is injected at load time);
        #   output layout: already `unknown/<word>_<file>`.
        silence_counts = {"train": 0, "valid": 0, "test": 0}
        for split, lines in load_split_lists(Path(args.split_lists)).items():
            for line in lines:
                label, fname = line.split("/", 1)
                if label == "_silence_":
                    silence_counts[split] += 1
                    continue
                if label == BACKGROUND_DIR:
                    continue  # linked into every split below
                if label == "unknown":
                    word, base = fname.split("_", 1)
                    assignments.append((split, label, fname, src / word / base))
                elif label in keywords:
                    assignments.append((split, label, fname, src / label / fname))
                else:
                    assignments.append(
                        (split, "unknown", f"{label}_{fname}", src / label / fname)
                    )
        if any(silence_counts.values()):
            print(
                "Per-split silence counts from the lists (pass as "
                "--num-silent / --num-silent-valid / --num-silent-test): "
                f"{silence_counts}"
            )
    else:
        rng = random.Random(args.seed)
        unknown_pool = {"train": [], "valid": [], "test": []}
        keyword_counts = {"train": 0, "valid": 0, "test": 0}
        for label_dir in sorted(src.iterdir()):
            if not label_dir.is_dir() or label_dir.name == BACKGROUND_DIR:
                continue
            word = label_dir.name
            for wav in sorted(label_dir.glob("*.wav")):
                split = which_set(wav.name, args.validation_pct, args.testing_pct)
                if word in keywords:
                    assignments.append((split, word, wav.name, wav))
                    keyword_counts[split] += 1
                else:
                    unknown_pool[split].append((word, wav))
        for split, pool in unknown_pool.items():
            want = int(keyword_counts[split] * args.unknown_pct / 100.0)
            rng.shuffle(pool)
            for word, wav in pool[:want]:
                assignments.append((split, "unknown", f"{word}_{wav.name}", wav))

    made = 0
    for split, label, name, src_file in assignments:
        dst = out / split / label / name
        dst.parent.mkdir(parents=True, exist_ok=True)
        if not dst.exists():
            place(src_file, dst)
            made += 1

    # background noise into every split (the loader reads it per split dir)
    noise_src = src / BACKGROUND_DIR
    if noise_src.is_dir():
        for split in ("train", "valid", "test"):
            for wav in sorted(noise_src.glob("*.wav")):
                dst = out / split / BACKGROUND_DIR / wav.name
                dst.parent.mkdir(parents=True, exist_ok=True)
                if not dst.exists():
                    place(wav, dst)

    counts = {}
    for split in ("train", "valid", "test"):
        n = sum(1 for _ in (out / split).glob("*/*.wav")) if (out / split).exists() else 0
        counts[split] = n
    print(f"Placed {made} files. Split sizes: {counts}")
    print("Silence class is injected at load time (--num-silent); no dir needed.")


if __name__ == "__main__":
    sys.exit(main())
