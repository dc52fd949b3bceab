"""The benchmark's own operation and byte counts, from shapes alone, and
the card's published peaks. A later change to the program cannot move
them."""
