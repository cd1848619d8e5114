"""Training transforms on packed storage (drop/grow, optimizer-slot carry)."""
