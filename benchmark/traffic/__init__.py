"""Window drivers, one a traffic kind."""
