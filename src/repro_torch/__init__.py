"""PyTorch/CUDA port of the Dirigent reproduction (NVIDIA Hopper target).

The package mirrors ``repro`` module for module so a reader finds each
counterpart under the same name. It imports ``torch``, numpy and the
standard library only — nothing of JAX and nothing of ``repro``: the
framework-neutral orchestrator (``core/``, ``simcore/``, ``configs/``) is
kept here as its own copy.

Entry points (``Replica``, ``LiveBackend``, ``ExecutableCache.warm``) run on
the GPU unless the caller names another device; with no CUDA device they
raise instead of carrying on on the CPU.
"""
