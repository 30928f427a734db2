"""Device operations: ``rank`` (the rank algebra both search routes share;
no kernel code) and ``search_kernel`` (the Pallas search kernel)."""
