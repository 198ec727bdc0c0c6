"""Host staging of the device-resident encode: the self time of the
``resident.stage`` (the chunk rows, candidate and limit arrays) and
``resident.upload`` (pinning and the host-to-device copies' enqueue)
spans per MB (10^6 bytes) of the window's input, in ms per MB."""
from bench_port.lib import spans


def read(ctx):
    return spans.staging_ms_per_mb(ctx)
