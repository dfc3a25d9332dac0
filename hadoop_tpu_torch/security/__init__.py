"""HTTP authentication for the serving door (the hadoop-auth filter)."""
