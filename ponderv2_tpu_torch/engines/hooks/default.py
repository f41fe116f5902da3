"""Hook base: six trainer events (counterpart of
``ponderv2_tpu/engines/hooks/default.py``)."""

from __future__ import annotations


class HookBase:
    trainer = None  # weakref proxy, set by TrainerBase.register_hooks

    def before_train(self):
        pass

    def before_epoch(self):
        pass

    def before_step(self):
        pass

    def after_step(self):
        pass

    def after_epoch(self):
        pass

    def after_train(self):
        pass
