"""The native text parser (``parser.cpp``) and its ctypes loader."""
