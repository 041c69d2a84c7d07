"""The host scene builder in C++ (builder.py, src/builder.cpp)."""
