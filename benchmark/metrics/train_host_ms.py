"""Host milliseconds of one `Trainer.train_step` call (the enqueue, before
the loss is read back), the mean over the unprofiled window's steps."""


def read(r):
    return r.host_ms if r.kind == "train" else None
