"""The benchmark of ``repro_torch``: warm exact triangle counts on the card.

One command runs one cell of ``BENCHMARK.json`` once::

    python tcbench/run.py --workload graph500-s19.warm --seed 7 \
        --seconds 10 --trace 0

The harness is driven by data. A cell names a configuration
(``configs/<name>.json``: the generator and its sizes, the session's
options, the plain reference), a traffic mix (``mixes/<name>.json``, the
parameters of the loop it names in ``loops/``) and, through
``BENCHMARK.json``, the
metrics it reports; each metric is read by ``metrics/<name>.py``. A later
cell, mix or metric is added as files and entries, without editing a file
that is here.

Inputs come from ``--seed`` through the frozen generators in
``generators/`` (torch, on the card). The answer of every count is held to
the plain reference in ``references/`` (torch or NumPy, no code of the
program), which works from the CSR the harness handed over.
"""
