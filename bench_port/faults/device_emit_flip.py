"""The resident encode's device emit alters the first token of every
block (its literal count)."""


def install(setattr):
    from smallz4_tpu_torch.ops import pipeline

    emit = pipeline.dev_emit.emit_block_device

    def bad_emit(*a, **k):
        payload, n_out = emit(*a, **k)
        payload = payload.clone()
        payload[0] ^= 0x10
        return payload, n_out

    setattr(pipeline.dev_emit, "emit_block_device", bad_emit)
