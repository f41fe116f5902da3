"""How the port's CPU tests compile their JAX references.

Nearly all of a heavy parity test's time is the JAX reference's compile on
the CPU: tracing and lowering (Python, one thread) and XLA's compile, whose
LLVM passes take most of the CPU time. Two things keep that down without
changing the graph that runs:

- ``COMPILER_OPTIONS`` compiles with LLVM's optimization level 0. The HLO
  is the same, and so are the ops, their order and their dtypes (the band
  convs' Pallas kernels still run in interpret mode); only the machine
  code differs, which halves the compile's CPU time (the multi-dataset
  pretrain's forward: 70.5 -> 36.0 CPU seconds). Its f32 results differ
  from the default level's in the last bits (LLVM contracts a multiply
  and an add into one FMA at the default level, not at 0): 2.7e-07 at most
  over SpUNetNoSkipBase's outputs and grads. ``test_torch_train.py:
  run_two_steps`` compiles at the default level (``compiler_options=None``):
  it holds each grad to 1e-4 of its own max|ref|, and against the level-0
  reference ``backbone.down.0.1.bias`` differed by 1.055e-06, over its
  bound of 9.27e-07 (against the default level's it passes).
- ``background_compile(jitted, *args)`` lowers ``jitted`` at ``args`` now
  (tracing and lowering hold the GIL) and hands XLA's compile, which
  releases it, to a thread; it returns a future of the compiled function,
  which takes the same arguments as ``jitted``. A fixture that needs
  several JAX graphs lowers them one after another and lets their compiles
  run beside each other and beside the port's own work. (Lowering in the
  thread as well made ``test_torch_train_scannet.py`` slower alone, 123 ->
  204 s: the tracing and the port's torch calls take turns at the GIL.)

``jit`` is ``jax.jit`` with ``COMPILER_OPTIONS``; ``compile_now`` compiles
an already jitted function (the JAX package's ``make_train_step``, say)
with them.
"""

from concurrent.futures import Future, ThreadPoolExecutor

import jax

COMPILER_OPTIONS = {"xla_backend_optimization_level": 0}

_POOL = ThreadPoolExecutor(max_workers=4, thread_name_prefix="jax-compile")


def jit(fun=None, **kwargs):
    if fun is None:  # as a decorator with arguments
        return lambda f: jit(f, **kwargs)
    return jax.jit(fun, compiler_options=COMPILER_OPTIONS, **kwargs)


def compile_now(jitted, *args):
    return jitted.lower(*args).compile(COMPILER_OPTIONS)


def background_compile(jitted, *args, compiler_options=COMPILER_OPTIONS) -> Future:
    return _POOL.submit(jitted.lower(*args).compile, compiler_options)
