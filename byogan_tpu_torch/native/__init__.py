"""The port's native image-IO library (``byogan_io.cpp``) and its build."""
