"""The benchmark of the port (``src/repro_torch``) on one H100: the
harness, its yardsticks and the plain reference. ``run.py`` runs one
cell; ``README.md`` says how cells, configurations, traffic mixes and
metrics are found."""
