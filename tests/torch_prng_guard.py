"""Registers hypothesis' PRNG at import, for the port's test files that
import it.

Hypothesis registers its own PRNG, after a ``gc.collect()``, at the first
``@given`` test of a thread.  In a worker that ran the JAX package's grpc
tests earlier (tests/test_rpc.py, tests/test_process_scheduler.py), that
collection finalizes their aio servers after their event loop closed, and
the worker then hangs at exit (ROADMAP C7).  Importing this module while
a worker collects runs that registration, and its collection, before any
test.  The proper fix belongs with the grpc tests' teardown."""

from hypothesis.internal.entropy import deterministic_PRNG

with deterministic_PRNG():
    pass
