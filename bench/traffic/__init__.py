"""Traffic: each mix is a data file ``<mix>.json`` whose ``kind`` names
the generator module ``<kind>.py`` that drives it.  A generator module
has ``lowered_rows(mix, rows)`` (the rows the pipeline is lowered at)
and ``Client(mix, cfg, inputs, call, probe, seed)`` with ``warm_up()``,
``request()`` (one request of the closed loop, waited for on the host;
returns the rows it processed), ``drop_program()`` and
``judge(ref, count, seed)`` (the compared numbers of the first
``count`` requests' answers)."""
