"""update_device_ms.train: device ms a training step spends in the
update (Adam's step, the learning rate, the weight clip, the sparsity
schedules, the EMA): the time between the `lpcnet.train.update` span's two
events on the trainer's stream, mean a step over the traced stretch."""

from benchmark.yardstick.spans import span_means


def read(ctx):
    m = span_means(ctx)
    return None if m is None else m.device_ms.get("lpcnet.train.update")
