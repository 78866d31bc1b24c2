"""The port side of the real-data accuracy-parity harness
(``python -m mtvaf_tpu_torch.parity.harness``): the five BASELINE.json
configs through the reference's own trainer and the port's CLI, and the
0.3-point table; ``--dry_run`` builds a synthetic reference-layout tree
and checkpoints (:mod:`.synth`) to run the plumbing without real data.
Host code; nothing on the compute path imports it."""
