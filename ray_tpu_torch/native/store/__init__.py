from ray_tpu_torch.native.store.native_store import (NativeObjectStore,
                                                     native_store_available)
from ray_tpu_torch.native.store.segment import (SharedSegment,
                                                create_segment,
                                                is_shared_memory_path,
                                                open_segment, segment_dir)

__all__ = ["NativeObjectStore", "SharedSegment", "create_segment",
           "is_shared_memory_path", "native_store_available",
           "open_segment", "segment_dir"]
