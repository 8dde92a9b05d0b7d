"""graph_replay_share.stage: graph_replay_share
(metrics/graph_replay_share.py) in the MOO-STAGE cells, which report no
end-to-end search time: this reading names front_phv as the end-to-end
metric of those cells."""

from pathlib import Path

from portbench.harness import load_reader

read = load_reader("graph_replay_share", Path(__file__).resolve().parents[2])
