"""Multi-device paths of the port on torch.distributed (port of
lora_tpu/parallel): the ('time', 'channel') mesh of ranks, the channel-bank
sharded demod, the halo-exchanged time-sharded stream, the corner-turn
channelizer, the mixed-config dispatcher and the multi-process set-up.
Every function takes the rank's local shard and returns its local result;
gather_result builds lora_tpu's global view."""

from .mesh import (Mesh, make_mesh, channel_sharding, shard_demodulate,
                   aggregate_metrics, gather_result)
from .halo import left_margin, halo_exchange, demodulate_stream
from .channelize import channelize_stream
from .dispatch import ChannelDispatcher, GroupResult

__all__ = [
    "ChannelDispatcher",
    "GroupResult",
    "Mesh",
    "make_mesh",
    "channel_sharding",
    "shard_demodulate",
    "aggregate_metrics",
    "gather_result",
    "left_margin",
    "halo_exchange",
    "demodulate_stream",
    "channelize_stream",
]
