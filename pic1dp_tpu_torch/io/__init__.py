"""I/O: snapshot output stream and PETSc-binary compatibility."""
