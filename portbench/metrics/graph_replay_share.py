"""graph_replay_share: of the chunks the evaluator ran on the card in the
window's searches, the percent served by replaying a captured CUDA graph
(the program's counter ``noc.eval.graph.replay``) rather than run eagerly,
a capture included (``noc.eval.graph.eager``). None where neither counted:
a program without graph replays, or no chunk on the card."""

from portbench.spans import records

REPLAY, EAGER = "noc.eval.graph.replay", "noc.eval.graph.eager"


def read(run):
    recs = records(run)
    if recs is None:
        return None
    replay = sum(r["counts"].get(REPLAY, 0) for r in recs)
    total = replay + sum(r["counts"].get(EAGER, 0) for r in recs)
    return 100.0 * replay / total if total else None
