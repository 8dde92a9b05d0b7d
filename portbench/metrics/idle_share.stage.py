"""idle_share.stage: idle_share (metrics/idle_share.py) in the MOO-STAGE cells. Their search
time spreads too widely from run to run for an end-to-end bound, so it is
read per layer there, and this reading names front_phv as the end-to-end
metric of those cells."""

from pathlib import Path

from portbench.harness import load_reader

read = load_reader("idle_share", Path(__file__).resolve().parents[2])
