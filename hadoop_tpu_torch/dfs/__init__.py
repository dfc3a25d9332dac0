"""The port's DFS: the client (``client``), the protocols
(``protocol``), the NameNode (``namenode``), the DataNode
(``datanode``) and WebHDFS on the NameNode (``webhdfs``)."""
