"""Evaluation: phase-1 frame-index precompute (``precompute.py``), the
phase-2 harness (``harness.py``) and the benchmark task registry.

The task modules, ``caching.py``, ``text_metrics.py`` and ``llm_judge.py``
are the port's own copies of the JAX package's jax-free modules of the same
names under ``tspo_tpu/eval/``, with relative imports, so that the port
imports nothing of that package.
"""
