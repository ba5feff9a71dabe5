from .advection import Advection
from .game_of_life import GameOfLife
from .particles import Particles
from .poisson import Poisson
from .vlasov import Vlasov

__all__ = ["Advection", "GameOfLife", "Particles", "Poisson", "Vlasov"]
