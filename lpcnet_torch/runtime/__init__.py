"""Native host runtime bindings (ctypes over the library built from
`native/lpcnet_runtime.cc`) and multi-stream serving (`serving`)."""

from .bindings import native_available, runtime  # noqa: F401
