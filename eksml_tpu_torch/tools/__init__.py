"""Operational tools of the port, each run as ``python -m``:

- :mod:`serve_loadtest` — closed- and open-loop load against a serving
  track, the request bank, and the shadow replay that scores a canary
  track against the stable one;
- :mod:`eksml_operator` — the elastic autoscaling operator (capacity +
  goodput → topology, relaunching ``python -m eksml_tpu_torch.train``
  ranks through the forced checkpoint) and, with ``--promote``, the
  canary promotion controller;
- :mod:`render_charts` — the GPU charts rendered without helm, held to
  their goldens in ``charts/golden-gpu/``;
- :mod:`bench` — the training ladder: images/s per GPU by rung, the
  first step apart, MFU and the roofline's prediction beside each;
- :mod:`eval_ckpt` — a training checkpoint's COCO AP from the command
  line.
"""
