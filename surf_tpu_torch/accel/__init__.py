"""The bitsru8 traversal and its hand-written leaf-row kernel."""
