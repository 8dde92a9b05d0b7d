"""eval_wait_ms.stage: eval_wait_ms (metrics/eval_wait_ms.py) in the MOO-STAGE
cells, which report no end-to-end search time: this reading names front_phv
as the end-to-end metric of those cells."""

from pathlib import Path

from portbench.harness import load_reader

read = load_reader("eval_wait_ms", Path(__file__).resolve().parents[2])
