"""The world tier's runtime: the launcher (``launch``), the world
communicator (``transport.WorldComm``) and the ctypes binding of the native
transport (``bridge``)."""
