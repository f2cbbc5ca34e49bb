"""Native host-side helpers of the port (ctypes bindings built from the
repository's ``runtime/*.cpp`` into the package's ``build/``)."""
