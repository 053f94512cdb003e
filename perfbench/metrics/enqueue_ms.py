"""Host milliseconds to enqueue one step (``Model.interp_step``, or
``Model.train_step`` with its optimizer), from an idle queue, before any
synchronisation (three steps, averaged). Serves ``enqueue_ms.<cells>``."""


def read(record):
    return record.get("enqueue_ms")
