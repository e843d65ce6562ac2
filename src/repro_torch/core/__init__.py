"""Host-side core of the port: the FlexArena/PagedArena admission arenas."""
