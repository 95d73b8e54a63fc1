"""Plain references of the benchmark's model families, one module each,
named by the key ``reference`` of a configuration's file.

A reference module is plain PyTorch at float32 and imports only
``__future__``, ``math``, ``typing`` and ``torch`` (and modules of this
folder): nothing of the program it checks, of JAX or of the JAX package.
It names the program's pieces by string alone. It defines:

* ``FAMILY``: the model family (``"dense"``, ``"ssm"``, or a new one);
  the run's ``Record.family``.
* ``arch_kwargs(spec) -> dict``: the program's config fields for the
  configuration file ``spec``; the harness builds ``ArchConfig(**kw)``.
  Where the model needs a config type of its own, the dict also holds
  ``program_config``: ``"repro_torch.<module>:<name>"``, a callable of the
  program that the harness imports and calls with the other fields.
* optionally ``token_flops(spec, positions) -> float``: the model
  operations (a multiply-add counts 2) of one decoded token that attends
  over ``positions`` positions, read by ``decode_mfu``. Without it, the
  frozen count of ``harness/costs.py`` serves the ``dense`` and ``ssm``
  families, and any other family's ``decode_mfu`` is left out.
* ``draw_weights(spec, seed, device) -> dict``: the weights a sandbox
  seeded ``seed`` serves, drawn again by a frozen copy of the program's
  rule, never read from the program.
* ``logits(spec, w, seqs, precision="fp32") -> list``: each sequence's
  logits at every position, the comparison's (``precision`` ``"fp8"``:
  the control; ``"bf16"``: a witness).
* ``forward(spec, w, tokens, precision="fp32")`` and
  ``decode(spec, w, tokens)``: the full forward and the same logits
  computed token by token, ``tokens`` in the module's own layout; the
  tests hold the two equal.
"""
