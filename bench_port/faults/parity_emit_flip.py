"""One byte of every block's payload altered where the parity encode
produces it: the host emit, which the device path and the CPU assist
share."""


def install(setattr):
    from smallz4_tpu_torch import native

    emit = native.emit_block

    def bad_emit(*a, **k):
        b = bytearray(emit(*a, **k))
        b[len(b) // 2] ^= 0x01
        return bytes(b)

    setattr(native, "emit_block", bad_emit)
