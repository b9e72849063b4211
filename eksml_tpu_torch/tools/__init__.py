"""Operational tools of the port, each run as ``python -m``:

- :mod:`serve_loadtest` — closed- and open-loop load against a serving
  track, the request bank, and the shadow replay that scores a canary
  track against the stable one;
- :mod:`eksml_operator` — the elastic autoscaling operator (capacity +
  goodput → topology, relaunching ``python -m eksml_tpu_torch.train``
  ranks through the forced checkpoint) and, with ``--promote``, the
  canary promotion controller.
"""
