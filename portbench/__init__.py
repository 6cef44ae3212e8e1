"""The port's benchmark: one run of one cell of ``BENCHMARK.json``
(``python3 -m portbench.run``), its plain reference renderer, the traffic
mixes, configurations, check limits and metric readers it finds by name."""
