"""The parity encode's device path trusts the device's claims: every
position of a device-path block reads as certified, so the host refine
and the distance fix skip them and the DP takes the claims as they came
back.  The CPU assist's blocks (a whole host search) are left as they
are.  The tempting fault of a later change that refines less."""


def install(setattr):
    from smallz4_tpu_torch.ops import chunkmatch, pipeline

    class TrustingChunkmatch:
        """``chunkmatch`` as the stream driver sees it, but for the
        certificate bits, which read all set."""

        def __getattr__(self, name):
            return getattr(chunkmatch, name)

        @staticmethod
        def unpack_bits_rows(bits, chunk):
            return chunkmatch.unpack_bits_rows(bits, chunk) | True

    setattr(pipeline, "cm", TrustingChunkmatch())
