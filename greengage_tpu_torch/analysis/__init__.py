"""Plan validation — the port's counterpart of greengage_tpu/analysis/
(``plancheck``; the ``gg check`` lints wait for ROADMAP Queue 1 item 12)."""
