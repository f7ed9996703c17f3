"""Native (C++) runtime components, built on demand with the system
toolchain (reference split: src/ray/* C++ runtime under the python API)."""
