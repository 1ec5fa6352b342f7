"""Dataset preprocessing: inverse-relation augmentation.

Port of ``redgnn_tpu/graph/preprocess.py`` (stdlib only; the files it
writes are byte-equal to the JAX package's). Counterpart of
`Temporal/interpolation/data/preprocess.py`, which downloads from mmkb and
writes `<ds>_aug` dirs with `~relation` inverses appended; only the
augmentation step is reproduced here, applied to an existing name-based
quadruple dir.
"""

from __future__ import annotations

import os


def augment_with_inverses(src_dir: str, dst_dir: str,
                          files=("train.txt", "valid.txt", "test.txt"),
                          wikidata_format: bool = False) -> None:
    """Write `<dst>/f` = lowercased originals + (t, ~r, h, time) inverses.

    ``wikidata_format`` handles the 5-column wikidata11k TSV
    (`preprocess.py:27-45`) where column 4 is the 'since' marker; in that
    mode the output contains ONLY the since-folded rewrites + their
    inverses — the raw originals are dropped, matching the reference
    (whose `result.writelines(lines)` is commented out).
    """
    os.makedirs(dst_dir, exist_ok=True)
    for fname in files:
        path = os.path.join(src_dir, fname)
        if not os.path.exists(path):
            continue
        with open(path) as f:
            lines = f.read().lower().splitlines()
        rows = [ln.split("\t") for ln in lines if ln.strip()]
        if wikidata_format:
            # wikidata11k's 5-column TSV (h, r, t, since, time): the
            # reference folds the 'since' marker into the relation name
            # and emits ONLY the rewritten rows + inverses — the raw
            # originals are not kept (`preprocess.py:36-45`, the
            # `result.writelines(lines)` there is commented out).
            out_lines = ["\t".join([h, f"{rel}-{since}", t, time])
                         for h, rel, t, since, time in (r[:5] for r in rows)]
            out_lines += ["\t".join([t, f"~{rel}-{since}", h, time])
                          for h, rel, t, since, time in (r[:5] for r in rows)]
        else:
            out_lines = list(lines)
            for r in rows:
                h, rel, t, time = r[:4]
                out_lines.append("\t".join([t, "~" + rel, h, time]))
        with open(os.path.join(dst_dir, fname), "w") as f:
            f.write("\n".join(out_lines) + "\n")
