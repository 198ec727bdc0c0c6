"""The device decode's block expansion alters one byte of every block."""


def install(setattr):
    from smallz4_tpu_torch.ops import decoder

    expand = decoder.expand_block

    def bad_expand(*a, **k):
        out = expand(*a, **k).clone()
        out[:, 100] ^= 0x01
        return out

    setattr(decoder, "expand_block", bad_expand)
