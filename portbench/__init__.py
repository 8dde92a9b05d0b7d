"""The port's benchmark: MOO-STAGE and its baseline through
``repro_torch.noc.run`` on the paper's 64- and 36-tile systems, one CUDA
device a cell. ``run.py`` runs one cell once; ``BENCHMARK.json`` at the
repository's root lists the cells and metrics."""
