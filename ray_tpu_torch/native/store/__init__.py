from ray_tpu_torch.native.store.native_store import (NativeObjectStore,
                                                     native_store_available)

__all__ = ["NativeObjectStore", "native_store_available"]
