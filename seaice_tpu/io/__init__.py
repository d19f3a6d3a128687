"""I/O: MPAS mesh reading, checkpoint/restart, output streams.

JAX replacement for the PIO/stream-manager layer the reference
links against (mpass_stream_manager; streams defined in
Registry.xml:1851-2248)."""

from .mesh_reader import read_mpas_mesh
from .checkpoint import (save_checkpoint, load_checkpoint,
                         write_restart_timestamp, read_restart_timestamp)
from .output import OutputStream
from .parallel import (save_sharded_checkpoint, load_sharded_checkpoint,
                       assemble_checkpoint, ShardedOutputStream,
                       assemble_history)
from .state_reader import (read_ice_state, write_ice_state,
                           init_state_from_file)
