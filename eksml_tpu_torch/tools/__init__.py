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
  line;
- :mod:`run_notebook` — a notebook's code cells run in order as a script
  (the viz notebooks where Jupyter's kernel machinery is absent);
- :mod:`run_report` — a markdown post-mortem of a training logdir
  (segments, incidents, elastic restores, goodput and effective MFU, the
  operator's and the fleet's trails, slow steps, cost by component, the
  roofline's predictions and calibration, collectives, memory, serving
  rounds);
- :mod:`goodput_report` — a logdir's whole-run goodput ledger and its
  effective MFU;
- :mod:`trace_summary` — a ``torch.profiler`` capture's device time by
  op family and component, and a run's host span traces merged on one
  timeline;
- :mod:`perf_gate` — the hermetic gate: one SMOKE-width step per rung
  counted on the CPU (or the card), priced on the H100 roofline,
  compared with the bank in ``artifacts/h100/``;
- :mod:`bench_gate` — the ladder's fresh lines against banked ones of
  the same rung, precision and card;
- :mod:`make_shapes_coco` — the learnable shapes dataset in COCO layout
  (the records carry their pixels; JPEGs where PIL imports);
- :mod:`convergence_run` — a few hundred steps on the shapes dataset and
  its COCO AP, against the reference's convergence gate;
- :mod:`op_microbench` — the RPN's NMS, anchor matching and proposals
  timed alone, the earlier formulations beside them;
- :mod:`bench_loader` — the images/s one host's loader builds;
- :mod:`bench_sweep` — the ladder's operating points, each in a
  subprocess with a timeout, as one artifact.

The reports and gates read ``--artifacts`` / ``--bank``, by default the
logdir or the port's own bank, never the TPU reference's ``artifacts/``
files.
"""
