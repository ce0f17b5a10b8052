"""Native (C++) components: built lazily with the system toolchain, always
with pure-Python fallbacks so the framework works without a compiler."""
