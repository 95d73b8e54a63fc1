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
  computed token by token, ``tokens`` in the layout ``BATCHED`` states;
  the tests hold the two equal. A ``forward`` that also takes
  ``parallel`` (default False) has a second, closed form of its
  recurrence, which the tests hold equal too.
* ``BATCHED``: True where ``forward`` and ``decode`` take ``tokens`` as
  (B, S) and return (B, S, V); False where they take one sequence (S,)
  and return (S, V).
* ``TINY``: the configuration fields that shrink this family to the CPU
  tests' size, laid over the configuration file by every CPU test that
  runs a configuration or a cell (``dict(spec, **TINY)``). They keep the
  family's shape rules: the heads divide the width, any state or head
  size divides it, and ``torch_dtype`` is ``"float32"``.

Adding a configuration takes new files and new entries of
``BENCHMARK.json`` only; no file that is there changes:

1. ``configs/<name>.json``: the model's fields as its source publishes
   them, with ``source``, ``reference`` (the module below), ``assumed``
   (each size set here, not by the source) and ``limits`` (each number
   ``harness/check.py`` compares, with its limit). A cut names each
   changed key in the entry's ``reduced``, gives its published value in
   ``published`` and states ``deployment.chips_per_layer``.
2. ``reference/<module>.py``, where no module here computes the family:
   ``FAMILY``, ``arch_kwargs``, ``BATCHED``, ``TINY``, ``draw_weights``,
   ``logits``, ``forward``, ``decode`` and, optionally, ``token_flops``,
   as above.
3. ``traffic/<mix>.json``, where no mix here fits.
4. In ``BENCHMARK.json``: the configuration under ``configs``, the cell
   under ``workloads``, and the cell's name appended to the
   ``workloads`` of ``tokens_per_s`` and of every per-layer metric it
   reports, ``create_warm_s`` and ``create_capture_s`` among them (the
   card test ``test_traced_run_reports_the_program_spans`` expects both
   of every cell).
5. ``metrics/<kernel>_roofline.py`` for each kernel the model brings,
   with its entry under ``per_layer``.

The CPU tests then find the configuration, its cell, its tiny size and
the model class its run builds from these files, and run the cell at its
``TINY`` size, sound and with each fault planted.
"""
